"""Soft Actor-Critic with the paper's architecture options (port of
``repro/rl/sac.py``).

``sac_init`` builds the reference's full state tree (actor, twin critics,
their targets, ``log_alpha``, OFENet, and the AdamW states under ``opt``)
so checkpoints line up leaf for leaf. ``sample_action`` and ``sac_update``
take their Gaussian noise as arguments, so a test can feed them the
reference's own draws. Parameters are plain tensors that never require
grad: each loss differentiates detached copies of its own subtree
(``common.value_and_grad``), so the fused stacks it only reads skip their
weight gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import (Params, ema_update, huber, tree_l2_norm,
                                tree_map, tree_update_ratio, value_and_grad)
from repro_torch.core import ofenet as ofe
from repro_torch.core.blocks import (MLPBlockConfig, mlp_block_apply,
                                     mlp_block_init)
from repro_torch.core.ofenet import OFENetConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


@dataclasses.dataclass(frozen=True)
class SACConfig:
    obs_dim: int
    act_dim: int
    num_units: int = 256
    num_layers: int = 2
    connectivity: str = "densenet"     # paper's MLP-DenseNet
    activation: str = "swish"
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    init_alpha: float = 0.1
    huber: bool = True                 # paper A.1
    block_backend: str = "jnp"         # jnp | fused stack kernel (blocks.py)
    grad_norms: bool = False
    ofenet: Optional[OFENetConfig] = None

    @property
    def z_s_dim(self) -> int:
        return self.ofenet.state_feature_dim if self.ofenet else self.obs_dim

    @property
    def z_sa_dim(self) -> int:
        return (self.ofenet.sa_feature_dim if self.ofenet
                else self.obs_dim + self.act_dim)

    def actor_block(self) -> MLPBlockConfig:
        return MLPBlockConfig(
            in_dim=self.z_s_dim, num_layers=self.num_layers,
            num_units=self.num_units, connectivity=self.connectivity,
            activation=self.activation, out_dim=2 * self.act_dim,
            backend=self.block_backend)

    def critic_block(self) -> MLPBlockConfig:
        return MLPBlockConfig(
            in_dim=self.z_sa_dim, num_layers=self.num_layers,
            num_units=self.num_units, connectivity=self.connectivity,
            activation=self.activation, out_dim=1,
            backend=self.block_backend)


def sac_init(cfg: SACConfig, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
    """``{"params", "opt", "step"}``. ``generator`` must live on the
    target device."""
    dev = resolve_device(device)
    critics = {"q1": mlp_block_init(generator, cfg.critic_block(), dev),
               "q2": mlp_block_init(generator, cfg.critic_block(), dev)}
    params: Params = {
        "actor": mlp_block_init(generator, cfg.actor_block(), dev),
        "critics": critics,
        "target_critics": tree_map(torch.clone, critics),
        "log_alpha": torch.tensor(math.log(cfg.init_alpha),
                                  dtype=torch.float32, device=dev),
    }
    if cfg.ofenet is not None:
        params["ofenet"] = ofe.ofenet_init(generator, cfg.ofenet, dev)
    opt = {"actor": adamw_init(params["actor"]),
           "critics": adamw_init(params["critics"]),
           "alpha": adamw_init(params["log_alpha"])}
    if cfg.ofenet is not None:
        opt["ofenet"] = adamw_init(params["ofenet"]["online"])
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _features(params: Params, cfg: SACConfig, s, a=None, which="online"):
    """(z_s, z_sa) either via OFENet or raw concatenation."""
    if cfg.ofenet is None:
        return s, (None if a is None else torch.cat([s, a], dim=-1))
    z_s, z_sa, _ = ofe.features(params["ofenet"], cfg.ofenet, s, a,
                                train=False, which=which)
    return z_s, z_sa


def actor_dist(params: Params, cfg: SACConfig, z_s: torch.Tensor):
    out, _, _ = mlp_block_apply(params["actor"], cfg.actor_block(), z_s,
                                train=False)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(params: Params, cfg: SACConfig, s: torch.Tensor,
                  eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tanh-squashed Gaussian sample + log-prob, for noise ``eps`` of the
    action batch's shape."""
    z_s, _ = _features(params, cfg, s)
    mu, log_std = actor_dist(params, cfg, z_s)
    pre = mu + torch.exp(log_std) * eps
    a = torch.tanh(pre)
    logp = torch.sum(-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
                     - torch.log(torch.clamp(1 - a ** 2, min=1e-6)), dim=-1)
    return a, logp


def mean_action(params: Params, cfg: SACConfig,
                s: torch.Tensor) -> torch.Tensor:
    z_s, _ = _features(params, cfg, s)
    mu, _ = actor_dist(params, cfg, z_s)
    return torch.tanh(mu)


def q_values(critics: Params, params: Params, cfg: SACConfig, s, a,
             which: str = "online"):
    """``(q1, q2, penultimate feature of q1)``."""
    _, z_sa = _features(params, cfg, s, a, which=which)
    q1, feat, _ = mlp_block_apply(critics["q1"], cfg.critic_block(), z_sa,
                                  train=False)
    q2, _, _ = mlp_block_apply(critics["q2"], cfg.critic_block(), z_sa,
                               train=False)
    return q1[..., 0], q2[..., 0], feat


def sac_update(state: Params, cfg: SACConfig, batch: Dict[str, torch.Tensor],
               eps1: torch.Tensor, eps2: torch.Tensor
               ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """One SAC gradient step (+ the concurrent OFENet aux step, paper
    §3.1). ``eps1``/``eps2`` are the Gaussian draws (``(B, act_dim)``) of
    the next-state action and of the actor loss's action."""
    params, opt = state["params"], state["opt"]
    opt_cfg = AdamWConfig(lr=cfg.lr)
    s, a, r = batch["obs"], batch["act"], batch["rew"]
    s2, d = batch["next_obs"], batch["done"]
    w_is = batch.get("weight")          # PER importance weights, or None
    target_entropy = -float(cfg.act_dim)
    metrics: Dict[str, torch.Tensor] = {}
    new_params = dict(params)
    new_opt = dict(opt)

    # --- OFENet auxiliary update (decoupled from RL; eq. 1) ---------------
    if cfg.ofenet is not None:
        def ofe_loss(online):
            pk = {**params["ofenet"], "online": online}
            return ofe.aux_loss(pk, cfg.ofenet, s, a, s2)[0]
        l_aux, g = value_and_grad(ofe_loss, params["ofenet"]["online"])
        upd, opt_ofe = adamw_update(opt_cfg, g, opt["ofenet"],
                                    params["ofenet"]["online"])
        new_params["ofenet"] = ofe.target_update(
            {**params["ofenet"], "online": upd}, cfg.ofenet)
        new_opt["ofenet"] = opt_ofe
        metrics["aux_loss"] = l_aux
        if cfg.grad_norms:
            metrics["grad_norm_ofenet"] = tree_l2_norm(g)
            metrics["update_ratio_ofenet"] = tree_update_ratio(
                upd, params["ofenet"]["online"])
    work = new_params   # features below use the refreshed OFENet

    # --- critic update: target from the OLD target critics and alpha -----
    with torch.no_grad():
        alpha = torch.exp(params["log_alpha"])
        a2, logp2 = sample_action(work, cfg, s2, eps1)
        q1_t, q2_t, _ = q_values(params["target_critics"], work, cfg, s2,
                                 a2)
        disc = batch.get("disc")
        if disc is None:
            disc = cfg.gamma * (1.0 - d)
        q_target = r + disc * (torch.minimum(q1_t, q2_t) - alpha * logp2)

    def critic_loss(critics):
        q1, q2, _ = q_values(critics, work, cfg, s, a)
        e1, e2 = q1 - q_target, q2 - q_target
        l1, l2 = (huber(e1), huber(e2)) if cfg.huber \
            else (0.5 * e1 ** 2, 0.5 * e2 ** 2)
        if w_is is not None:
            return torch.mean(w_is * l1) + torch.mean(w_is * l2)
        return torch.mean(l1) + torch.mean(l2)

    l_q, g_q = value_and_grad(critic_loss, params["critics"])
    critics, opt_c = adamw_update(opt_cfg, g_q, opt["critics"],
                                  params["critics"])
    new_params["critics"] = critics
    new_opt["critics"] = opt_c
    if cfg.grad_norms:
        metrics["grad_norm_critics"] = tree_l2_norm(g_q)
        metrics["update_ratio_critics"] = tree_update_ratio(
            critics, params["critics"])

    # --- actor update, against the NEW critics ----------------------------
    def actor_loss(actor):
        w = {**work, "actor": actor}
        ai, logp = sample_action(w, cfg, s, eps2)
        q1, q2, _ = q_values(critics, w, cfg, s, ai)
        return torch.mean(alpha * logp - torch.minimum(q1, q2)), logp

    (l_pi, logp), g_pi = value_and_grad(actor_loss, params["actor"],
                                        has_aux=True)
    actor, opt_a = adamw_update(opt_cfg, g_pi, opt["actor"], params["actor"])
    new_params["actor"] = actor
    new_opt["actor"] = opt_a
    if cfg.grad_norms:
        metrics["grad_norm_actor"] = tree_l2_norm(g_pi)
        metrics["update_ratio_actor"] = tree_update_ratio(actor,
                                                          params["actor"])

    # --- temperature -------------------------------------------------------
    def alpha_loss(log_alpha):
        return -torch.mean(torch.exp(log_alpha) * (logp + target_entropy))
    l_al, g_al = value_and_grad(alpha_loss, params["log_alpha"])
    log_alpha, opt_al = adamw_update(opt_cfg, g_al, opt["alpha"],
                                     params["log_alpha"])
    new_params["log_alpha"] = log_alpha
    new_opt["alpha"] = opt_al

    # --- target nets ---------------------------------------------------------
    new_params["target_critics"] = ema_update(params["target_critics"],
                                              critics, cfg.tau)

    # priorities for PER: TD error of the NEW critics vs the pre-update target
    with torch.no_grad():
        q1, _, feat = q_values(critics, work, cfg, s, a)
    td = torch.abs(q1 - q_target)
    metrics.update({"critic_loss": l_q, "actor_loss": l_pi,
                    "alpha": torch.exp(log_alpha), "q_mean": torch.mean(q1),
                    "td_error": torch.mean(td)})
    return ({"params": new_params, "opt": new_opt, "step": state["step"] + 1},
            {**metrics, "priorities": td, "q_features": feat})
