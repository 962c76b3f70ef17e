"""Soft Actor-Critic: config, parameters and the acting path (port of
``repro/rl/sac.py``; ``sac_update`` comes with the training slice).

``sac_init`` builds the reference's full parameter tree (actor, twin
critics, their targets, ``log_alpha``, OFENet) so checkpoints line up leaf
for leaf. ``sample_action`` takes its Gaussian noise ``eps`` as an argument,
so a test can feed it the reference's own draw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import Params, tree_map
from repro_torch.core import ofenet as ofe
from repro_torch.core.blocks import (MLPBlockConfig, mlp_block_apply,
                                     mlp_block_init)
from repro_torch.core.ofenet import OFENetConfig

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
    """``{"params", "step"}``; the optimizer state comes with training.
    ``generator`` must live on the target device."""
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
    return {"params": params,
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
