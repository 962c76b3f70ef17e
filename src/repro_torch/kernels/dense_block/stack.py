"""Fused MLP-DenseNet stack forward (port of
``repro/kernels/dense_block/stack.py``).

``dense_stack(x, ws, bs)`` returns what ``core.blocks.mlp_block_apply``
calls the feature: the whole stream ``[x|y0|...|y_{L-1}]`` for densenet,
the last hidden layer for mlp and d2rl.

* On a CUDA tensor it launches the hand-written kernel
  ``csrc/dense_stack_fwd.cu`` once per layer on PyTorch's current stream,
  or raises. There is no fallback: a CUDA tensor never takes the plain
  path. The kernel's backward (the port of ``_bwd_kernel``) is not written
  yet, so differentiating through it raises ``NotImplementedError``.
* On a CPU tensor it runs ``dense_stack_ref``, the plain PyTorch concat
  loop, which autograd differentiates as usual. This is the reference the
  kernel is held against on the card.

Buffer layout (logical widths, no lane padding; see the kernel's header):
densenet writes every layer into its column slot of one ``(M, d0 + L*U)``
buffer, which is returned; mlp and d2rl alternate between two ``(M, U)``
buffers, and d2rl hands the kernel its input as the segments ``[h | x]``,
the order of the weight's logical rows.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.common import get_activation

FUSED_CONNECTIVITIES = ("mlp", "densenet", "d2rl")
FUSED_ACTIVATIONS = ("swish", "silu", "relu", "tanh", "identity")
_ACT_CODE = {"identity": 0, "relu": 1, "tanh": 2, "swish": 3, "silu": 3}

SOURCE = Path(__file__).resolve().parent / "csrc" / "dense_stack_fwd.cu"
# (BM, BN, BK) per kernel config id — must match dense_layer_fwd's switch
_CONFIGS = ((16, 64, 32), (32, 64, 32), (64, 64, 16))
# split K until the grid holds about this many blocks per SM
_BLOCKS_PER_SM = 2
# ... but give each split at least this many BK chunks
_MIN_CHUNKS_PER_SPLIT = 4

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count`` (one per
    layer of every stack forward that ran on the card)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def _validate(connectivity: str, activation: str, ws, bs) -> None:
    if connectivity not in FUSED_CONNECTIVITIES:
        raise ValueError(f"connectivity {connectivity!r} not fused; "
                         f"have {FUSED_CONNECTIVITIES}")
    if activation not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not fused; "
                         f"have {FUSED_ACTIVATIONS}")
    if not ws or len(ws) != len(bs):
        raise ValueError("dense_stack needs at least one layer and one "
                         "bias per weight")


def feature_dim(connectivity: str, num_layers: int, d0: int, u: int) -> int:
    return d0 + num_layers * u if connectivity == "densenet" else u


def in_dim(connectivity: str, i: int, d0: int, u: int) -> int:
    """Logical input width of layer i (``MLPBlockConfig.layer_in_dims``)."""
    if connectivity == "densenet":
        return d0 + i * u
    if i == 0:
        return d0
    return u + d0 if connectivity == "d2rl" else u


# ---------------------------------------------------------------------------
# plain PyTorch version: the reference, and the path for CPU tensors
# ---------------------------------------------------------------------------

def dense_stack_ref(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    bs: Sequence[torch.Tensor], *,
                    connectivity: str = "densenet",
                    activation: str = "swish") -> torch.Tensor:
    """The concat loop of ``stack.py::dense_stack_ref``, on 2-D ``x``."""
    act = get_activation(activation)
    stream, h = x, x
    for i, (w, b) in enumerate(zip(ws, bs)):
        if connectivity == "densenet":
            inp = stream
        elif connectivity == "d2rl" and i > 0:
            inp = torch.cat([h, x], dim=-1)
        else:
            inp = h
        h = act(inp @ w + b)
        if connectivity == "densenet":
            stream = torch.cat([stream, h], dim=-1)
    return stream if connectivity == "densenet" else h


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_fwd", [SOURCE])
    fn = lib.dense_layer_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, ll, i, p, ll, i, p, p, p, ll, p, p, i, i, i,
                       i, i, p]
        fn.restype = ctypes.c_int
    return lib


def plan(m: int, n: int, k: int, num_sms: int) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, chunks_per_split)`` of one layer launch.

    The tile config follows the rows (serving slots of 1-32 rows use thin
    row tiles); K is split so the grid holds ~``_BLOCKS_PER_SM`` blocks
    per SM even when the output has few tiles."""
    config = 0 if m <= 16 else 1 if m <= 32 else 2
    bm, bn, bk = _CONFIGS[config]
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    want = -(-_BLOCKS_PER_SM * num_sms // tiles)
    splits = max(1, min(want, chunks // _MIN_CHUNKS_PER_SPLIT))
    per_split = -(-chunks // splits)
    return config, tiles, -(-chunks // per_split), per_split


def _launch_layer(lib, seg1: Tuple[torch.Tensor, int],
                  seg2: Optional[Tuple[torch.Tensor, int]],
                  w: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                  col: int, act: int, num_sms: int, stream: int) -> None:
    """``out[:, col:col+N] = act([seg1 | seg2] @ w + b)``; a segment is
    ``(tensor, first column)`` and spans ``w``'s matching rows."""
    a1, c1 = seg1
    m, n = out.shape[0], w.shape[1]
    k2 = 0 if seg2 is None else seg2[0].shape[1] - seg2[1]
    k1 = w.shape[0] - k2
    config, tiles, splits, per_split = plan(m, n, k1 + k2, num_sms)
    ws_buf = counters = None
    if splits > 1:
        ws_buf = torch.empty((splits, m, n), device=out.device,
                             dtype=torch.float32)
        counters = torch.zeros((tiles,), device=out.device, dtype=torch.int32)
    a2_ptr, lda2 = None, 0
    if seg2 is not None:
        a2, c2 = seg2
        a2_ptr, lda2 = a2.data_ptr() + 4 * c2, a2.stride(0)
    err = lib.dense_layer_fwd(
        config, a1.data_ptr() + 4 * c1, a1.stride(0), k1, a2_ptr, lda2, k2,
        w.data_ptr(), b.data_ptr(), out.data_ptr() + 4 * col, out.stride(0),
        None if ws_buf is None else ws_buf.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, n, act, splits, per_split, stream)
    if err != 0:
        raise RuntimeError(f"dense_layer_fwd launch failed: CUDA error {err} "
                           f"(m={m}, n={n}, k={k1 + k2}, config={config}, "
                           f"splits={splits})")
    _count_launch()


def _check_cuda(x: torch.Tensor, ws, bs, connectivity: str) -> None:
    d0, u = x.shape[1], ws[0].shape[1]
    for name, t in [("x", x)] + [(f"ws[{i}]", w) for i, w in enumerate(ws)] \
            + [(f"bs[{i}]", b) for i, b in enumerate(bs)]:
        if t.device != x.device:
            raise ValueError(f"dense_stack: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dense_stack kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dense_stack kernel needs contiguous tensors; "
                             f"{name} is not")
    for i, (w, b) in enumerate(zip(ws, bs)):
        want = (in_dim(connectivity, i, d0, u), u)
        if tuple(w.shape) != want or tuple(b.shape) != (u,):
            raise ValueError(f"dense_stack layer {i}: w {tuple(w.shape)}, "
                             f"b {tuple(b.shape)}; want w {want}, b ({u},)")


def _kernel_forward(x: torch.Tensor, ws, bs, connectivity: str,
                    activation: str) -> torch.Tensor:
    _check_cuda(x, ws, bs, connectivity)
    m, d0 = x.shape
    n_layers, u = len(ws), ws[0].shape[1]
    dev = x.device
    out_w = feature_dim(connectivity, n_layers, d0, u)
    if m == 0:
        return torch.empty((0, out_w), device=dev, dtype=torch.float32)
    lib = _library()
    act = _ACT_CODE[activation]
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        if connectivity == "densenet":
            out = torch.empty((m, out_w), device=dev, dtype=torch.float32)
            out[:, :d0].copy_(x)
            for i in range(n_layers):
                d = d0 + i * u
                _launch_layer(lib, (out, 0), None, ws[i], bs[i], out, d, act,
                              num_sms, stream)
            return out
        bufs = [torch.empty((m, u), device=dev, dtype=torch.float32)
                for _ in range(min(n_layers, 2))]
        h = x
        for i in range(n_layers):
            dst = bufs[i % 2]
            seg2 = (x, 0) if connectivity == "d2rl" and i > 0 else None
            _launch_layer(lib, (h, 0), seg2, ws[i], bs[i], dst, 0, act,
                          num_sms, stream)
            h = dst
        return h


class _StackKernel(torch.autograd.Function):
    """The kernel as an autograd node; its backward is the training
    slice's port of ``_bwd_kernel`` and raises until then."""

    @staticmethod
    def forward(ctx, x, connectivity, activation, *params):
        n_layers = len(params) // 2
        return _kernel_forward(x, params[:n_layers], params[n_layers:],
                               connectivity, activation)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "dense_stack has no CUDA backward yet (port of stack.py::"
            "_bwd_kernel); differentiate on the CPU or wait for the "
            "training slice")


def dense_stack(x: torch.Tensor, ws: Sequence[torch.Tensor],
                bs: Sequence[torch.Tensor], *, connectivity: str = "densenet",
                activation: str = "swish") -> torch.Tensor:
    """Feature of the L-layer stack: the kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring)."""
    _validate(connectivity, activation, ws, bs)
    d0, u = x.shape[-1], ws[0].shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d0)
    if x.device.type == "cpu":
        out = dense_stack_ref(x2, ws, bs, connectivity=connectivity,
                              activation=activation)
    elif x.device.type == "cuda":
        out = _StackKernel.apply(x2, connectivity, activation, *ws, *bs)
    else:
        raise ValueError(f"dense_stack runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return out.reshape(*lead, feature_dim(connectivity, len(ws), d0, u))
