"""Circular transition store + per-actor n-step rollback ring (port of
``repro/replay/store.py``).

The store is a dict of preallocated ``(capacity, ...)`` tensors plus an
int32 write cursor and live count, all on the device; ``store_add`` writes
in place and never syncs with the host (the cursor arithmetic stays on the
device). The n-step ring (Ape-X n-step returns, Horgan et al. 2018) sits in
front of the store: each incoming 1-step transition displaces the one from
n-1 steps ago, emitted with the discounted reward sum over its window and
a ``disc`` bootstrap coefficient (gamma^span * (1-done), truncated at
episode boundaries).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Store = Dict[str, object]   # {"data": {...}, "ptr": i32, "count": i32}

# per-actor ring fields mirrored from the collectors' transition dicts
_NSTEP_FIELDS = ("obs", "act", "rew", "next_obs", "done", "boundary")


def store_init(capacity: int, obs_dim: int, act_dim: int, device=None,
               extra_fields: Tuple[str, ...] = ()) -> Store:
    c = int(capacity)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=device)
    data = {"obs": z(c, obs_dim), "act": z(c, act_dim), "rew": z(c),
            "next_obs": z(c, obs_dim), "done": z(c)}
    for f in extra_fields:          # scalar-per-row extras (e.g. n-step disc)
        data[f] = z(c)
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {"data": data, "ptr": i32(), "count": i32()}


def store_capacity(store: Store) -> int:
    return store["data"]["rew"].shape[0]


def store_add(store: Store, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Store, torch.Tensor]:
    """Append a transition batch at the cursor (wrapping), in place;
    returns ``(store, written row indices)``. A batch longer than the
    store keeps its last ``capacity`` rows, the host buffer's sequential
    last-write-wins outcome."""
    cap = store_capacity(store)
    n = batch["obs"].shape[0]
    ptr = store["ptr"]
    if n > cap:
        batch = {k: v[-cap:] for k, v in batch.items()}
        ptr = ptr + (n - cap)
    idx = (ptr + torch.arange(min(n, cap), dtype=torch.int32,
                              device=ptr.device)) % cap
    rows = idx.long()
    for k, v in store["data"].items():
        v.index_copy_(0, rows, batch[k].to(v.dtype))
    store["ptr"] = ((store["ptr"] + n) % cap).to(torch.int32)
    store["count"] = torch.clamp(store["count"] + n, max=cap).to(torch.int32)
    return store, idx


def store_gather(store: Store, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    rows = idx.long()
    return {k: v[rows] for k, v in store["data"].items()}


# --------------------------------------------------------------------------
# n-step rollback buffer (Ape-X n-step returns, computed in the add path)
# --------------------------------------------------------------------------

def nstep_init(n: int, n_actors: int, obs_dim: int, act_dim: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Ring holding each actor's ``n`` most recent 1-step transitions."""
    shapes = {"obs": (obs_dim,), "act": (act_dim,), "rew": (),
              "next_obs": (obs_dim,), "done": (), "boundary": ()}
    buf = {k: torch.zeros((int(n), int(n_actors)) + s, dtype=torch.float32,
                          device=device) for k, s in shapes.items()}
    buf["t"] = torch.zeros((), dtype=torch.int32, device=device)
    return buf


def nstep_push(n: int, gamma: float, buf: Dict[str, torch.Tensor],
               tr: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Push one env step per actor; emit the transition from n-1 steps ago.

    ``tr`` fields are ``(n_actors, ...)``. The emitted batch carries the
    n-step reward sum and ``disc = gamma^span * (1 - done)`` where the
    window truncates at the first episode ``boundary``. Emissions are valid
    once the ring is primed: the caller drops the first n-1 pushes."""
    t = buf["t"]
    slot = (t % n).long()
    out = {}
    for k in _NSTEP_FIELDS:
        out[k] = buf[k].clone()
        out[k].index_copy_(0, slot.reshape(1), tr[k].to(buf[k].dtype)[None])
    out["t"] = t + 1
    # window oldest-first: ring[(slot + 1 + j) % n], j = 0 .. n-1
    order = (slot + 1 + torch.arange(n, device=slot.device)) % n
    win = {k: out[k].index_select(0, order) for k in _NSTEP_FIELDS}
    alive = torch.ones_like(win["rew"][0])       # no boundary before step j
    rew = torch.zeros_like(win["rew"][0])
    next_obs = torch.zeros_like(win["next_obs"][0])
    done = torch.zeros_like(win["done"][0])
    disc = torch.zeros_like(win["done"][0])
    for j in range(n):
        rew = rew + (gamma ** j) * alive * win["rew"][j]
        # one-hot selector for the last step of the window: the first
        # boundary, or step n-1 when the window is boundary-free
        last = alive * (win["boundary"][j] if j < n - 1
                        else torch.ones_like(alive))
        next_obs = next_obs + last[:, None] * win["next_obs"][j]
        done = done + last * win["done"][j]
        disc = disc + last * (gamma ** (j + 1)) * (1.0 - win["done"][j])
        alive = alive * (1.0 - win["boundary"][j])
    emitted = {"obs": win["obs"][0], "act": win["act"][0], "rew": rew,
               "next_obs": next_obs, "done": done, "disc": disc}
    return out, emitted


def nstep_push_seq(n: int, gamma: float, buf: Dict[str, torch.Tensor],
                   trs: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``nstep_push`` over a ``(steps, n_actors, ...)`` sequence; emitted
    fields come back ``(steps, n_actors, ...)`` in push order."""
    outs = []
    for s in range(trs["obs"].shape[0]):
        buf, em = nstep_push(n, gamma, buf, {k: trs[k][s]
                                             for k in _NSTEP_FIELDS})
        outs.append(em)
    return buf, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def nstep_emit_flat(n: int, gamma: float, buf: Dict[str, torch.Tensor],
                    trs: Dict[str, torch.Tensor], steps: int, drop: int = 0
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Roll a collector's flat ``(steps * n_actors, ...)`` transitions
    through the ring and return store-schema rows, flat again, without the
    first ``drop`` (unprimed) emissions."""
    seq = {k: v.reshape((steps, -1) + v.shape[1:]) for k, v in trs.items()}
    buf, emitted = nstep_push_seq(n, gamma, buf, seq)
    flat = {k: v[drop:].reshape((-1,) + v.shape[2:])
            for k, v in emitted.items()}
    return buf, flat
