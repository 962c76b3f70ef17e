"""OFENet state and state-action features, trained decoupled from RL by
the auxiliary next-state loss (port of ``repro/core/ofenet.py``).

With densenet connectivity the feature width grows: ``phi_s`` emits
``dim(s) + L*U`` columns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.common import (Params, dense_apply, dense_init, ema_update,
                                tree_map)
from repro_torch.core.blocks import (MLPBlockConfig, mlp_block_apply,
                                     mlp_block_init)


@dataclasses.dataclass(frozen=True)
class OFENetConfig:
    state_dim: int
    action_dim: int
    num_layers: int = 8          # paper A.4: 8-layer DenseNet
    num_units: int = 256
    connectivity: str = "densenet"
    activation: str = "swish"
    batch_norm: bool = True      # paper uses BN inside OFENet
    tau: float = 0.005           # target-net smoothing (paper A.1)
    block_backend: str = "jnp"   # jnp | fused (BN-off only; see blocks.py)

    @property
    def state_block(self) -> MLPBlockConfig:
        return MLPBlockConfig(
            in_dim=self.state_dim, num_layers=self.num_layers,
            num_units=self.num_units, connectivity=self.connectivity,
            activation=self.activation, batch_norm=self.batch_norm,
            backend=self.block_backend)

    @property
    def sa_block(self) -> MLPBlockConfig:
        return MLPBlockConfig(
            in_dim=self.state_feature_dim + self.action_dim,
            num_layers=self.num_layers, num_units=self.num_units,
            connectivity=self.connectivity, activation=self.activation,
            batch_norm=self.batch_norm, backend=self.block_backend)

    @property
    def state_feature_dim(self) -> int:
        return self.state_block.feature_dim

    @property
    def sa_feature_dim(self) -> int:
        return self.sa_block.feature_dim


def ofenet_init(generator: torch.Generator, cfg: OFENetConfig,
                device: torch.device) -> Params:
    online = {
        "phi_s": mlp_block_init(generator, cfg.state_block, device),
        "phi_sa": mlp_block_init(generator, cfg.sa_block, device),
        # f_pred: linear map z_sa -> s_{t+1}   (eq. 1)
        "pred": dense_init(generator, cfg.sa_feature_dim, cfg.state_dim,
                           device),
    }
    return {"online": online, "target": tree_map(torch.clone, online)}


def features(params: Params, cfg: OFENetConfig, s: torch.Tensor,
             a: Optional[torch.Tensor] = None, *, train: bool = False,
             which: str = "online"
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Params]:
    """``(z_s, z_sa, refreshed params)``; ``z_sa`` is None when ``a`` is."""
    net = params[which]
    z_s, _, new_phi_s = mlp_block_apply(net["phi_s"], cfg.state_block, s,
                                        train=train)
    z_sa, new_phi_sa = None, net["phi_sa"]
    if a is not None:
        z_sa, _, new_phi_sa = mlp_block_apply(
            net["phi_sa"], cfg.sa_block, torch.cat([z_s, a], dim=-1),
            train=train)
    new_net = {**net, "phi_s": new_phi_s, "phi_sa": new_phi_sa}
    return z_s, z_sa, {**params, which: new_net}


def aux_loss(params: Params, cfg: OFENetConfig, s: torch.Tensor,
             a: torch.Tensor, s_next: torch.Tensor
             ) -> Tuple[torch.Tensor, Params]:
    """Auxiliary next-state prediction loss (eq. 1), on the online net."""
    _, z_sa, new_params = features(params, cfg, s, a, train=True,
                                   which="online")
    pred = dense_apply(params["online"]["pred"], z_sa)
    loss = torch.mean(torch.sum(torch.square(pred - s_next), dim=-1))
    return loss, new_params


def target_update(params: Params, cfg: OFENetConfig) -> Params:
    return {**params, "target": ema_update(params["target"],
                                           params["online"], cfg.tau)}
