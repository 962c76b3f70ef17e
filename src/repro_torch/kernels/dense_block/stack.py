"""Fused MLP-DenseNet stack, forward and backward (port of
``repro/kernels/dense_block/stack.py``).

``dense_stack(x, ws, bs)`` returns what ``core.blocks.mlp_block_apply``
calls the feature: the whole stream ``[x|y0|...|y_{L-1}]`` for densenet,
the last hidden layer for mlp and d2rl.

* On a CUDA tensor it launches the hand-written kernel
  ``csrc/dense_stack_fwd.cu`` once per layer on PyTorch's current stream,
  or raises. There is no fallback: a CUDA tensor never takes the plain
  path. When autograd will differentiate the call, the forward also keeps
  every layer's pre-activation in an ``(M, L*U)`` side buffer, and the
  backward (``_StackKernel.backward``, the port of ``_bwd_kernel``)
  launches ``csrc/dense_stack_bwd.cu`` layer by layer in reverse; it
  computes only the gradients autograd asks for, and it is bitwise the
  same from run to run (no floating-point atomics).
* On a CPU tensor it runs ``dense_stack_ref``, the plain PyTorch concat
  loop, which autograd differentiates as usual. This is the reference the
  kernels are held against on the card (``dense_stack_grads_ref`` for the
  backward).

Workspaces, counters and scratch are ``torch.empty`` tensors freed after
the launch: PyTorch's caching allocator hands their memory out again only
in stream order, after the kernel has run.

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

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "dense_stack_fwd.cu"
BWD_SOURCE = _CSRC / "dense_stack_bwd.cu"
HEADER = _CSRC / "dense_tile.cuh"
# (BM, BN, BK) per kernel config id — must match dense_layer_fwd's switch
_CONFIGS = ((16, 64, 32), (32, 64, 32), (64, 64, 16))
# split K until the grid holds about this many blocks per SM
_BLOCKS_PER_SM = 2
# ... but give each split at least this many BK chunks
_MIN_CHUNKS_PER_SPLIT = 4

_count_lock = threading.Lock()
_launches = 0
_bwd_launches = 0


def launch_count() -> int:
    """Forward kernel launches since the last ``reset_launch_count`` (one
    per layer of every stack forward that ran on the card)."""
    return _launches


def bwd_launch_count() -> int:
    """Backward calls on the card since the last ``reset_launch_count``
    (one per stack backward; each launches the kernels of
    ``dense_stack_bwd.cu`` for every layer it reaches)."""
    return _bwd_launches


def reset_launch_count() -> None:
    global _launches, _bwd_launches
    with _count_lock:
        _launches = 0
        _bwd_launches = 0


def _count_launch(backward: bool = False) -> None:
    global _launches, _bwd_launches
    with _count_lock:
        if backward:
            _bwd_launches += 1
        else:
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


def dense_stack_grads_ref(x: torch.Tensor, ws: Sequence[torch.Tensor],
                          bs: Sequence[torch.Tensor], g: torch.Tensor, *,
                          connectivity: str = "densenet",
                          activation: str = "swish"):
    """``(dx, dws, dbs)`` of ``<dense_stack_ref(x, ws, bs), g>``: autograd of
    the plain version, the reference the backward kernel is held against."""
    with torch.enable_grad():
        var = [t.detach().requires_grad_(True) for t in (x, *ws, *bs)]
        out = dense_stack_ref(var[0], var[1:1 + len(ws)],
                              var[1 + len(ws):], connectivity=connectivity,
                              activation=activation)
        grads = torch.autograd.grad(out, var, g)
    n = len(ws)
    return grads[0], list(grads[1:1 + n]), list(grads[1 + n:])


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_fwd", [SOURCE], [HEADER])
    fn = lib.dense_layer_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, ll, i, p, ll, i, p, p, p, ll, p, ll, p, p, i,
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_bwd", [BWD_SOURCE], [HEADER])
    if lib.dense_bwd_gemm.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dense_bwd_act_grad.argtypes = [p, ll, p, ll, p, p, i, i, i, p]
        lib.dense_bwd_act.argtypes = [p, ll, p, i, i, i, p]
        lib.dense_bwd_gemm.argtypes = [i, i, i, p, ll, i, p, ll, i, p, ll,
                                       p, ll, i, p, p, i, i, i, i, p]
        for fn in (lib.dense_bwd_act_grad, lib.dense_bwd_act,
                   lib.dense_bwd_gemm):
            fn.restype = ctypes.c_int
    return lib


def plan(m: int, n: int, k: int, num_sms: int) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, chunks_per_split)`` of one tile product
    with an ``(m, n)`` output and a reduction of length ``k``.

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


def _split_buffers(m: int, n: int, tiles: int, splits: int,
                   dev: torch.device):
    """Workspace and per-tile counters of a split reduction (None, None
    without one)."""
    if splits == 1:
        return None, None
    return (torch.empty((splits, m, n), device=dev, dtype=torch.float32),
            torch.zeros((tiles,), device=dev, dtype=torch.int32))


def _ptr(t: Optional[torch.Tensor], col: int = 0):
    """Address of column ``col`` of row 0 of a float32 tensor (or None)."""
    return None if t is None else t.data_ptr() + 4 * col


def _launch_layer(lib, seg1: Tuple[torch.Tensor, int],
                  seg2: Optional[Tuple[torch.Tensor, int]],
                  w: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                  col: int, act: int, num_sms: int, stream: int,
                  z: Optional[Tuple[torch.Tensor, int]] = None) -> None:
    """``out[:, col:col+N] = act([seg1 | seg2] @ w + b)``; a segment is
    ``(tensor, first column)`` and spans ``w``'s matching rows. ``z``
    ``(tensor, first column)`` receives the pre-activation when given."""
    a1, c1 = seg1
    m, n = out.shape[0], w.shape[1]
    k2 = 0 if seg2 is None else seg2[0].shape[1] - seg2[1]
    k1 = w.shape[0] - k2
    config, tiles, splits, per_split = plan(m, n, k1 + k2, num_sms)
    ws_buf, counters = _split_buffers(m, n, tiles, splits, out.device)
    a2_ptr, lda2 = None, 0
    if seg2 is not None:
        a2_ptr, lda2 = _ptr(*seg2), seg2[0].stride(0)
    z_ptr, ldz = (None, 0) if z is None else (_ptr(*z), z[0].stride(0))
    err = lib.dense_layer_fwd(
        config, _ptr(a1, c1), a1.stride(0), k1, a2_ptr, lda2, k2,
        w.data_ptr(), b.data_ptr(), _ptr(out, col), out.stride(0), z_ptr,
        ldz, _ptr(ws_buf), _ptr(counters), m, n, act, splits, per_split,
        stream)
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
                    activation: str, zs: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The stack's feature; with ``zs`` (``(M, L*U)``), layer i also stores
    its pre-activation into columns ``[i*U, (i+1)*U)``."""
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

        def z_slot(i):
            return None if zs is None else (zs, i * u)
        if connectivity == "densenet":
            out = torch.empty((m, out_w), device=dev, dtype=torch.float32)
            out[:, :d0].copy_(x)
            for i in range(n_layers):
                d = d0 + i * u
                _launch_layer(lib, (out, 0), None, ws[i], bs[i], out, d, act,
                              num_sms, stream, z_slot(i))
            return out
        bufs = [torch.empty((m, u), device=dev, dtype=torch.float32)
                for _ in range(min(n_layers, 2))]
        h = x
        for i in range(n_layers):
            dst = bufs[i % 2]
            seg2 = (x, 0) if connectivity == "d2rl" and i > 0 else None
            _launch_layer(lib, (h, 0), seg2, ws[i], bs[i], dst, 0, act,
                          num_sms, stream, z_slot(i))
            h = dst
        return h


class _Backward:
    """One stack backward on the card: the launches of
    ``dense_stack_bwd.cu`` (see its header), layer by layer in reverse."""

    def __init__(self, m: int, u: int, activation: str, dev: torch.device):
        self.lib = _bwd_library()
        self.m, self.u, self.dev = m, u, dev
        self.act = _ACT_CODE[activation]
        self.num_sms = torch.cuda.get_device_properties(
            dev).multi_processor_count
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def _empty(self, *shape) -> torch.Tensor:
        return torch.empty(shape, device=self.dev, dtype=torch.float32)

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")

    def act_grad(self, g: torch.Tensor, gcol: int, zs: torch.Tensor,
                 i: int, need_db: bool):
        """``(gz, db)`` of layer i: ``g[:, gcol:gcol+U] * act'(z_i)``."""
        gz = self._empty(self.m, self.u)
        db = self._empty(self.u) if need_db else None
        self._check(self.lib.dense_bwd_act_grad(
            _ptr(g, gcol), g.stride(0), _ptr(zs, i * self.u), zs.stride(0),
            gz.data_ptr(), _ptr(db), self.m, self.u, self.act, self.stream),
            "dense_bwd_act_grad")
        return gz, db

    def act_of(self, zs: torch.Tensor, i: int) -> torch.Tensor:
        """``act(z_i)``: layer i's output, for mlp/d2rl."""
        h = self._empty(self.m, self.u)
        self._check(self.lib.dense_bwd_act(
            _ptr(zs, i * self.u), zs.stride(0), h.data_ptr(), self.m,
            self.u, self.act, self.stream), "dense_bwd_act")
        return h

    def _gemm(self, ta: int, tw: int, a: torch.Tensor, acol: int, k: int,
              w: torch.Tensor, wrow: int, out: torch.Tensor, ocol: int,
              orow: int, m: int, n: int, accumulate: bool) -> None:
        config, tiles, splits, per_split = plan(m, n, k, self.num_sms)
        ws_buf, counters = _split_buffers(m, n, tiles, splits, self.dev)
        self._check(self.lib.dense_bwd_gemm(
            config, ta, tw, _ptr(a, acol), a.stride(0), k, None, 0, 0,
            _ptr(w, wrow * w.stride(0)), w.stride(0),
            _ptr(out, orow * out.stride(0) + ocol), out.stride(0),
            int(accumulate), _ptr(ws_buf), _ptr(counters), m, n, splits,
            per_split, self.stream), "dense_bwd_gemm")

    def dw(self, inp: torch.Tensor, col: int, k: int, gz: torch.Tensor,
           dw: torch.Tensor, row: int) -> None:
        """``dw[row:row+k] = inp[:, col:col+k]^T @ gz`` (reduces the batch)."""
        self._gemm(1, 0, inp, col, self.m, gz, 0, dw, 0, row, k, self.u,
                   False)

    def dinput(self, gz: torch.Tensor, w: torch.Tensor, row: int, k: int,
               out: torch.Tensor, col: int, accumulate: bool) -> None:
        """``out[:, col:col+k] (+)= gz @ w[row:row+k]^T`` (reduces U)."""
        self._gemm(0, 1, gz, 0, self.u, w, row, out, col, 0, self.m, k,
                   accumulate)


def _kernel_backward(saved, ws, g: torch.Tensor, connectivity: str,
                     activation: str, need_dx: bool, need_dw, need_db):
    """``(dx, dws, dbs)`` on the card, None where not asked for. ``saved``
    is the forward's output stream (densenet) or its input ``x`` (mlp,
    d2rl), then the pre-activations ``zs``."""
    stream_or_x, zs = saved
    n_layers, u = len(ws), ws[0].shape[1]
    d0 = ws[0].shape[0]
    m = zs.shape[0]
    dws: list = [None] * n_layers
    dbs: list = [None] * n_layers
    wanted = [i for i in range(n_layers) if need_dw[i] or need_db[i]]
    lowest = 0 if need_dx else (min(wanted) if wanted else n_layers)
    if lowest == n_layers or m == 0:
        return None, dws, dbs
    if g.dtype != torch.float32:
        raise TypeError(f"dense_stack backward takes a float32 gradient, "
                        f"got {g.dtype}")
    dev = g.device
    with torch.cuda.device(dev):
        bw = _Backward(m, u, activation, dev)
        g = g.contiguous()
        if connectivity == "densenet":
            gb = g.clone()          # gradient stream, accumulated in place
            for i in reversed(range(lowest, n_layers)):
                k = d0 + i * u
                gz, dbs[i] = bw.act_grad(gb, k, zs, i, need_db[i])
                if need_dw[i]:
                    dws[i] = bw._empty(k, u)
                    bw.dw(stream_or_x, 0, k, gz, dws[i], 0)
                if i > lowest or need_dx:
                    bw.dinput(gz, ws[i], 0, k, gb, 0, accumulate=True)
            dx = gb[:, :d0].contiguous() if need_dx else None
        else:
            x = stream_or_x
            d2rl = connectivity == "d2rl"
            gh = g
            gx = torch.zeros((m, d0), device=dev) if need_dx and d2rl \
                else None
            for i in reversed(range(lowest, n_layers)):
                gz, dbs[i] = bw.act_grad(gh, 0, zs, i, need_db[i])
                h_prev = bw.act_of(zs, i - 1) if i > 0 else x
                if need_dw[i]:
                    dws[i] = bw._empty(ws[i].shape[0], u)
                    bw.dw(h_prev, 0, h_prev.shape[1], gz, dws[i], 0)
                    if d2rl and i > 0:           # weight rows [h | x]
                        bw.dw(x, 0, d0, gz, dws[i], u)
                if i == 0:
                    if need_dx and d2rl:
                        bw.dinput(gz, ws[0], 0, d0, gx, 0, accumulate=True)
                    elif need_dx:
                        gx = bw._empty(m, d0)
                        bw.dinput(gz, ws[0], 0, d0, gx, 0, accumulate=False)
                    continue
                if i == lowest:              # nothing below needs gh or dx
                    break
                gh = bw._empty(m, u)
                bw.dinput(gz, ws[i], 0, u, gh, 0, accumulate=False)
                if need_dx and d2rl:
                    bw.dinput(gz, ws[i], u, d0, gx, 0, accumulate=True)
            dx = gx
    _count_launch(backward=True)
    return dx, dws, dbs


class _StackKernel(torch.autograd.Function):
    """The kernels as an autograd node: forward keeps the pre-activations,
    backward is ``dense_stack_bwd.cu``."""

    @staticmethod
    def forward(ctx, x, connectivity, activation, *params):
        n_layers = len(params) // 2
        ws, bs = params[:n_layers], params[n_layers:]
        u = ws[0].shape[1]
        zs = torch.empty((x.shape[0], n_layers * u), device=x.device,
                         dtype=torch.float32)
        out = _kernel_forward(x, ws, bs, connectivity, activation, zs)
        ctx.connectivity, ctx.activation = connectivity, activation
        keep = out if connectivity == "densenet" else x
        ctx.save_for_backward(keep, zs, *ws)
        return out

    @staticmethod
    def backward(ctx, g):
        keep, zs, *ws = ctx.saved_tensors
        n_layers = len(ws)
        need = ctx.needs_input_grad
        dx, dws, dbs = _kernel_backward(
            (keep, zs), ws, g, ctx.connectivity, ctx.activation, need[0],
            need[3:3 + n_layers], need[3 + n_layers:])
        return (dx, None, None, *dws, *dbs)


def dense_stack(x: torch.Tensor, ws: Sequence[torch.Tensor],
                bs: Sequence[torch.Tensor], *, connectivity: str = "densenet",
                activation: str = "swish") -> torch.Tensor:
    """Feature of the L-layer stack: the kernels for CUDA tensors, the plain
    version for CPU tensors (see the module docstring)."""
    _validate(connectivity, activation, ws, bs)
    d0, u = x.shape[-1], ws[0].shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d0)
    if x.device.type == "cpu":
        out = dense_stack_ref(x2, ws, bs, connectivity=connectivity,
                              activation=activation)
    elif x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x2, *ws, *bs)):
            out = _StackKernel.apply(x2.contiguous(), connectivity,
                                     activation, *ws, *bs)
        else:
            out = _kernel_forward(x2.contiguous(), ws, bs, connectivity,
                                  activation)
    else:
        raise ValueError(f"dense_stack runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    return out.reshape(*lead, feature_dim(connectivity, len(ws), d0, u))
