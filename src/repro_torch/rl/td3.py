"""TD3 (Fujimoto et al. 2018) with the paper's architecture options (port
of ``repro/rl/td3.py``).

``td3_init`` builds the reference's full state tree (actor, twin critics,
their targets, OFENet, and the AdamW states under ``opt``), so
checkpoints line up leaf for leaf. ``td3_update`` takes the target
policy's smoothing noise as an argument (``(B, act_dim)`` standard
normals), so a test can feed the reference's own draw.

The delayed policy update is branch-free: the actor's gradient and AdamW
step run every step, and ``torch.where`` on the device flag ``step %
policy_delay == 0`` picks the new or the old actor and AdamW state (its
``count`` included) and the target actor's Polyak rate. Nothing reads
that flag on the host, so one CUDA graph of the superstep serves both
parities. The reference's XLA drops ``q2`` where only ``q1`` is read (the
actor loss, the priorities); the port does not compute it there.
``Policy`` serves both algorithms, so TD3's acting path is here too."""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class TD3Config:
    obs_dim: int
    act_dim: int
    num_units: int = 256
    num_layers: int = 2
    connectivity: str = "densenet"
    activation: str = "swish"
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    expl_noise: float = 0.1
    huber: bool = True
    block_backend: str = "jnp"
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
            activation=self.activation, out_dim=self.act_dim,
            final_activation="tanh", backend=self.block_backend)

    def critic_block(self) -> MLPBlockConfig:
        return MLPBlockConfig(
            in_dim=self.z_sa_dim, num_layers=self.num_layers,
            num_units=self.num_units, connectivity=self.connectivity,
            activation=self.activation, out_dim=1,
            backend=self.block_backend)


def td3_init(cfg: TD3Config, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
    """``{"params", "opt", "step"}``. ``generator`` must live on the
    target device."""
    dev = resolve_device(device)
    critics = {"q1": mlp_block_init(generator, cfg.critic_block(), dev),
               "q2": mlp_block_init(generator, cfg.critic_block(), dev)}
    actor = mlp_block_init(generator, cfg.actor_block(), dev)
    params: Params = {
        "actor": actor, "critics": critics,
        "target_actor": tree_map(torch.clone, actor),
        "target_critics": tree_map(torch.clone, critics),
    }
    if cfg.ofenet is not None:
        params["ofenet"] = ofe.ofenet_init(generator, cfg.ofenet, dev)
    opt = {"actor": adamw_init(actor), "critics": adamw_init(critics)}
    if cfg.ofenet is not None:
        opt["ofenet"] = adamw_init(params["ofenet"]["online"])
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _features(params: Params, cfg: TD3Config, s, a=None):
    """(z_s, z_sa) either via OFENet or raw concatenation."""
    if cfg.ofenet is None:
        return s, (None if a is None else torch.cat([s, a], dim=-1))
    z_s, z_sa, _ = ofe.features(params["ofenet"], cfg.ofenet, s, a,
                                train=False)
    return z_s, z_sa


def policy(params: Params, cfg: TD3Config, s: torch.Tensor,
           which: str = "actor") -> torch.Tensor:
    z_s, _ = _features(params, cfg, s)
    out, _, _ = mlp_block_apply(params[which], cfg.actor_block(), z_s,
                                train=False)
    return out


def q_values(critics: Params, params: Params, cfg: TD3Config, s, a):
    """``(q1, q2, penultimate feature of q1)``."""
    _, z_sa = _features(params, cfg, s, a)
    q1, feat, _ = mlp_block_apply(critics["q1"], cfg.critic_block(), z_sa,
                                  train=False)
    q2, _, _ = mlp_block_apply(critics["q2"], cfg.critic_block(), z_sa,
                               train=False)
    return q1[..., 0], q2[..., 0], feat


def _q1(critics: Params, params: Params, cfg: TD3Config, s, a):
    """``q_values`` without ``q2``: ``(q1, penultimate feature)``."""
    _, z_sa = _features(params, cfg, s, a)
    q1, feat, _ = mlp_block_apply(critics["q1"], cfg.critic_block(), z_sa,
                                  train=False)
    return q1[..., 0], feat


def td3_update(state: Params, cfg: TD3Config, batch: Dict[str, torch.Tensor],
               noise: torch.Tensor) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """One TD3 critic step, the delayed actor step and the targets (+ the
    concurrent OFENet aux step, paper §3.1). ``noise`` is the target
    policy's smoothing draw, standard normals of shape ``(B, act_dim)``."""
    params, opt = state["params"], state["opt"]
    opt_cfg = AdamWConfig(lr=cfg.lr)
    s, a, r = batch["obs"], batch["act"], batch["rew"]
    s2, d = batch["next_obs"], batch["done"]
    w_is = batch.get("weight")          # PER importance weights, or None
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

    # --- critic: target from the target actor + clipped noise and the OLD
    # target critics ---------------------------------------------------------
    with torch.no_grad():
        eps = torch.clamp(cfg.policy_noise * noise, -cfg.noise_clip,
                          cfg.noise_clip)
        a2 = torch.clamp(policy(work, cfg, s2, "target_actor") + eps, -1, 1)
        q1_t, q2_t, _ = q_values(params["target_critics"], work, cfg, s2,
                                 a2)
        disc = batch.get("disc")
        if disc is None:
            disc = cfg.gamma * (1.0 - d)
        q_target = r + disc * torch.minimum(q1_t, q2_t)

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

    # --- delayed actor, against the NEW critics, + targets ------------------
    def actor_loss(actor):
        w = {**work, "actor": actor}
        q1, _ = _q1(critics, w, cfg, s, policy(w, cfg, s))
        return -torch.mean(q1)

    do_policy = (state["step"] % cfg.policy_delay) == 0
    l_pi, g_pi = value_and_grad(actor_loss, params["actor"])
    actor_new, opt_a_new = adamw_update(opt_cfg, g_pi, opt["actor"],
                                        params["actor"])
    # select (params, opt state): zeroed grads would still move the params
    # through Adam's momentum
    pick = lambda new, old: tree_map(
        lambda x, y: torch.where(do_policy, x, y), new, old)
    actor = pick(actor_new, params["actor"])
    new_params["actor"] = actor
    if cfg.grad_norms:
        # ratio of the PICKED params: 0 on delayed steps
        metrics["grad_norm_actor"] = tree_l2_norm(g_pi)
        metrics["update_ratio_actor"] = tree_update_ratio(actor,
                                                          params["actor"])
    new_opt["actor"] = pick(opt_a_new, opt["actor"])
    new_params["target_actor"] = ema_update(
        params["target_actor"], actor, torch.where(do_policy, cfg.tau, 0.0))
    new_params["target_critics"] = ema_update(params["target_critics"],
                                              critics, cfg.tau)

    # priorities for PER: TD error of the NEW critics vs the pre-update target
    with torch.no_grad():
        q1, feat = _q1(critics, work, cfg, s, a)
    td = torch.abs(q1 - q_target)
    metrics.update({"critic_loss": l_q, "actor_loss": l_pi,
                    "q_mean": torch.mean(q1), "td_error": torch.mean(td)})
    return ({"params": new_params, "opt": new_opt, "step": state["step"] + 1},
            {**metrics, "priorities": td, "q_features": feat})
