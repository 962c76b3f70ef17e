"""Connectivity zoo from the paper (port of ``repro/core/blocks.py``).

* ``mlp``      y_i = f_i(y_{i-1})
* ``resnet``   y_i = f_i(y_{i-1}) + y_{i-1}
* ``densenet`` y_i = f_i([y_0, y_1, ..., y_{i-1}])   (the paper's choice)
* ``d2rl``     y_i = f_i([y_{i-1}, y_0])

``f_i`` is Dense -> (optional BatchNorm) -> activation. ``backend="fused"``
routes the hidden stack through ``kernels.dense_block.stack.dense_stack``
when ``MLPBlockConfig.fused_supported`` (mlp/densenet/d2rl, fused
activation, no BN, at least one layer) and keeps the plain layer loop for
every other config, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.common import (Params, dense_apply, dense_init,
                                get_activation)
from repro_torch.kernels.dense_block import stack as _stack

CONNECTIVITIES = ("mlp", "resnet", "densenet", "d2rl")
BLOCK_BACKENDS = ("jnp", "fused")


@dataclasses.dataclass(frozen=True)
class MLPBlockConfig:
    in_dim: int
    num_layers: int
    num_units: int
    connectivity: str = "densenet"
    activation: str = "swish"
    batch_norm: bool = False
    out_dim: Optional[int] = None          # if set, append a linear output layer
    final_activation: str = "identity"
    backend: str = "jnp"                   # jnp (plain loop) | fused (stack)

    def __post_init__(self):
        if self.connectivity not in CONNECTIVITIES:
            raise ValueError(f"connectivity must be one of {CONNECTIVITIES}")
        if self.backend not in BLOCK_BACKENDS:
            raise ValueError(f"backend must be one of {BLOCK_BACKENDS}")

    @property
    def fused_supported(self) -> bool:
        """Whether the fused stack covers this config exactly."""
        return (self.connectivity in _stack.FUSED_CONNECTIVITIES
                and self.activation in _stack.FUSED_ACTIVATIONS
                and not self.batch_norm and self.num_layers > 0)

    def layer_in_dims(self) -> Tuple[int, ...]:
        """Input width of each hidden layer under this connectivity."""
        dims = []
        d = self.in_dim
        for _ in range(self.num_layers):
            dims.append(d)
            if self.connectivity == "densenet":
                d = d + self.num_units
            elif self.connectivity == "d2rl":
                d = self.num_units + self.in_dim
            else:
                d = self.num_units
        return tuple(dims)

    @property
    def feature_dim(self) -> int:
        """Width of the feature emitted before the (optional) output layer."""
        if self.num_layers == 0:
            return self.in_dim
        if self.connectivity == "densenet":
            return self.in_dim + self.num_layers * self.num_units
        return self.num_units


def _bn_init(dim: int, device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device),
            "mean": torch.zeros((dim,), device=device),
            "var": torch.ones((dim,), device=device)}


def _bn_apply(p: Params, x: torch.Tensor, *, train: bool,
              momentum: float = 0.99, eps: float = 1e-5):
    """BatchNorm with running stats; returns (y, new_stats)."""
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = torch.mean(x, dim=dims)
        var = torch.mean(torch.square(x), dim=dims) - mean ** 2
        new_stats = {"mean": momentum * p["mean"] + (1 - momentum) * mean,
                     "var": momentum * p["var"] + (1 - momentum) * var}
    else:
        mean, var = p["mean"], p["var"]
        new_stats = {"mean": p["mean"], "var": p["var"]}
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_stats


def mlp_block_init(generator: torch.Generator, cfg: MLPBlockConfig,
                   device: torch.device) -> Params:
    layers = []
    for d_in in cfg.layer_in_dims():
        p: Params = {"dense": dense_init(generator, d_in, cfg.num_units,
                                         device)}
        if cfg.batch_norm:
            p["bn"] = _bn_init(cfg.num_units, device)
        layers.append(p)
    params: Params = {"layers": layers}
    if cfg.out_dim is not None:
        params["out"] = dense_init(generator, cfg.feature_dim, cfg.out_dim,
                                   device)
    return params


def mlp_block_apply(params: Params, cfg: MLPBlockConfig, x: torch.Tensor, *,
                    train: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """``(output, feature, new_params)``: ``feature`` is the penultimate
    representation; ``new_params`` carries refreshed BN running stats
    (``params`` itself when BN is off)."""
    if cfg.backend == "fused" and cfg.fused_supported:
        feature = _stack.dense_stack(
            x, [l["dense"]["w"] for l in params["layers"]],
            [l["dense"]["b"] for l in params["layers"]],
            connectivity=cfg.connectivity, activation=cfg.activation)
        out = feature
        if cfg.out_dim is not None:
            out = get_activation(cfg.final_activation)(
                dense_apply(params["out"], feature))
        return out, feature, params
    act = get_activation(cfg.activation)
    stream = x
    h = x
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        if cfg.connectivity == "densenet":
            inp = stream
        elif cfg.connectivity == "d2rl" and i > 0:
            inp = torch.cat([h, x], dim=-1)
        else:
            inp = h
        y = dense_apply(layer["dense"], inp)
        if cfg.batch_norm:
            y, stats = _bn_apply(layer["bn"], y, train=train)
            new_layers.append({**layer, "bn": {**layer["bn"], **stats}})
        y = act(y)
        if cfg.connectivity == "resnet" and h.shape[-1] == y.shape[-1]:
            y = y + h
        h = y
        if cfg.connectivity == "densenet":
            stream = torch.cat([stream, y], dim=-1)
    feature = stream if cfg.connectivity == "densenet" else h
    if cfg.num_layers == 0:
        feature = x
    out = feature
    if cfg.out_dim is not None:
        out = get_activation(cfg.final_activation)(
            dense_apply(params["out"], feature))
    new_params = {**params, "layers": new_layers} if cfg.batch_norm \
        else params
    return out, feature, new_params
