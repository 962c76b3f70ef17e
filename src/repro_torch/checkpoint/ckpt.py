"""Checkpoints: nested tensors <-> npz with path-keyed leaves (port of
``repro/checkpoint/ckpt.py``; same file format).

A leaf's key is its path with ``/`` between parts, rendered as the
reference's ``jax.tree_util.tree_flatten_with_path`` renders it: a dict
key as itself, a list index as its number, a namedtuple field as
``.name``; a ``None`` has no leaves, as in JAX. So
``{"loop": LoopTemplate(agent={"params": ...})}`` writes
``loop/.agent/params/actor/layers/0/dense/w`` exactly as a JAX
``Experiment.save`` does, and a checkpoint written by either package loads
in the other. Metadata rides inside the npz as the ``__meta__json`` uint8
entry, committed with the arrays by one ``os.replace``.
"""
from __future__ import annotations

import json
import os
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import annotate

META_KEY = "__meta__json"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's order (sorted dict keys)."""
    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], join(str(k)))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), join(f".{f}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, join(str(i)))
    elif tree is not None:
        yield prefix, tree


def _rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return {k: _rebuild(v, values, join(str(k))) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), values, join(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, join(str(i)))
                          for i, v in enumerate(tree))
    return None if tree is None else values[prefix]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, *, metadata: Optional[dict] = None) -> None:
    with annotate("repro.ckpt.save"):
        arrays = {k: _to_numpy(v) for k, v in _leaves(tree)}
        if metadata is not None:
            arrays[META_KEY] = np.frombuffer(
                json.dumps(metadata).encode("utf-8"), dtype=np.uint8)
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        # unique staging name; np.savez keeps a name that ends in ".npz"
        tag = f".{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp.npz"
        tmp = str(p) + tag
        np.savez(tmp, **arrays)
        os.replace(tmp, str(p))                      # THE commit point
        if metadata is not None:
            side_tmp = str(p) + ".meta.json" + tag
            Path(side_tmp).write_text(json.dumps(metadata, indent=1))
            os.replace(side_tmp, str(p) + ".meta.json")


def restore(path: str, template: Any, device: torch.device) -> Any:
    """Load the leaves ``template`` names (any tensor with a shape and a
    dtype, e.g. on the ``meta`` device) onto ``device``, in
    ``template``'s structure. Entries the template does not name are not
    read."""
    with annotate("repro.ckpt.restore"), \
            np.load(path, allow_pickle=False) as data:
        values = {}
        for key, tmpl in _leaves(template):
            if key not in data.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = torch.from_numpy(data[key])
            if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
                raise ValueError(
                    f"leaf {key}: {tuple(t.shape)} {t.dtype} in the "
                    f"checkpoint, {tuple(tmpl.shape)} {tmpl.dtype} expected")
            values[key] = t.to(device)
    return _rebuild(template, values)


def leaf_names(path: str) -> List[str]:
    """The names of a checkpoint's array entries (its metadata left out)."""
    with np.load(path, allow_pickle=False) as data:
        return [k for k in data.files if k != META_KEY]


def load_metadata(path: str) -> Optional[dict]:
    """The checkpoint's metadata dict, or None when it has none. The
    npz-embedded copy wins over the ``.meta.json`` sidecar."""
    p = Path(path)
    if p.exists():
        try:
            with np.load(str(p), allow_pickle=False) as data:
                if META_KEY in data.files:
                    return json.loads(bytes(data[META_KEY]).decode("utf-8"))
        except (OSError, ValueError):
            pass                 # torn/corrupt npz: let the sidecar speak
    meta = Path(str(p) + ".meta.json")
    return json.loads(meta.read_text()) if meta.exists() else None
