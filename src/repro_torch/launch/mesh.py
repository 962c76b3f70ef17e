"""The actor mesh of a sharded run (port of ``repro/launch/mesh.py``'s
``make_actor_mesh`` and ``replay_shards``).

The reference lays ``execution.mesh_shards=n`` over a ``data`` axis of n
devices: each slice runs its share of the actor pool and keeps its own
replay shard (``replay/sharded.py``). The port runs those n logical
shards on one card, stacked on a leading axis of every replay tensor, and
``torch.func.vmap`` over that axis reaches the sum-tree kernels' member
axis: one launch for all shards. Nothing here uses ``torch.distributed``:
NCCL takes one GPU per rank and cannot split one card into n ranks.

The reference's ``make_production_mesh`` and ``make_debug_mesh`` (a 2-D
or 3-D TPU pod mesh with a ``model`` axis, which its runner never uses)
and its TPU hardware constants have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ActorMesh:
    """``shards`` logical replay shards (actor slices) on one device."""
    shards: int
    device: torch.device

    def __post_init__(self):
        if not isinstance(self.shards, int) or self.shards < 1:
            raise ValueError(f"ActorMesh.shards must be an int >= 1, got "
                             f"{self.shards!r}")


def make_actor_mesh(n: int, device: DeviceLike = None) -> ActorMesh:
    """``n`` shards on ``device`` (default: the card)."""
    return ActorMesh(int(n), resolve_device(device))


def replay_shards(mesh: ActorMesh) -> int:
    """The replay shard count: total replay capacity is the per-shard
    capacity times this."""
    return mesh.shards
