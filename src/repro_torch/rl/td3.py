"""TD3: config, parameters and the deterministic policy (port of
``repro/rl/td3.py``; ``td3_update`` comes after the SAC training slice).
``Policy`` serves both algorithms, so TD3's acting path is here too."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import Params, tree_map
from repro_torch.core import ofenet as ofe
from repro_torch.core.blocks import (MLPBlockConfig, mlp_block_apply,
                                     mlp_block_init)
from repro_torch.core.ofenet import OFENetConfig


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
    """``{"params", "step"}`` with the reference's full parameter tree."""
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
    return {"params": params,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _features(params: Params, cfg: TD3Config, s):
    if cfg.ofenet is None:
        return s
    z_s, _, _ = ofe.features(params["ofenet"], cfg.ofenet, s, train=False)
    return z_s


def policy(params: Params, cfg: TD3Config, s: torch.Tensor,
           which: str = "actor") -> torch.Tensor:
    out, _, _ = mlp_block_apply(params[which], cfg.actor_block(),
                                _features(params, cfg, s), train=False)
    return out
