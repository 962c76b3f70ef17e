"""Fused MLP-DenseNet stack, forward and backward (port of
``repro/kernels/dense_block/stack.py``).

``dense_stack(x, ws, bs)`` returns what ``core.blocks.mlp_block_apply``
calls the feature: the whole stream ``[x|y0|...|y_{L-1}]`` for densenet,
the last hidden layer for mlp and d2rl.

* On a CUDA tensor it launches hand-written kernels of
  ``csrc/dense_stack_fwd.cu`` on PyTorch's current stream, or raises.
  There is no fallback: a CUDA tensor never takes the plain path.
  ``plan_fwd`` picks the kernel by the width U and the rows M: a
  densenet stack with U < 128 (the OFENet stacks) runs whole in ONE
  launch of the whole-stack kernel where its shared memory fits
  (``whole_smem``); otherwise, up to 32 rows (serving slots) the
  weight-streaming kernel, once per layer; from 128 rows, where U is too
  (densenet: the actor and critic stacks in training), the register tile
  of ``csrc/dense_tile_rt.cuh`` over a transposed copy of the stream,
  which one ``dense_fwd_stream_init`` launch per call starts and every
  layer's epilogue extends; otherwise ``csrc/dense_tile.cuh``, once per
  layer.
  When autograd will differentiate the call, the forward also keeps every
  layer's pre-activation in an ``(M, L*U)`` side buffer, and the backward
  (``_StackKernel.backward``, the port of ``_bwd_kernel``) launches
  ``csrc/dense_stack_bwd.cu`` layer by layer in reverse, W^T, dW and db on
  a side stream beside the act_grad -> dx chain; products of at least 128
  x 128 x 128 (every one of the actor and the critic) take the register
  tile of ``csrc/dense_tile_rt.cuh`` as ``plan_bwd`` plans them.
  It computes only the gradients autograd asks for, and it is bitwise the
  same from run to run (no floating-point atomics).
* On a CPU tensor it runs ``dense_stack_ref``, the plain PyTorch concat
  loop, which autograd differentiates as usual. This is the reference the
  kernels are held against on the card (``dense_stack_grads_ref`` for the
  backward).

Workspaces and scratch are ``torch.empty`` tensors freed after the
launch: PyTorch's caching allocator hands their memory out again only in
stream order, after the kernel has run (a tensor one stream makes and the
other uses is recorded for it). Split counters come from one zeroed
buffer per (device, stream) (``_tile_counters``), which every forward and
backward kernel leaves at zero, so no launch fills them. Under CUDA graph
capture the workspaces come from the graph's pool and keep their addresses
at replay; the counter buffers and the backward's side stream must already
be cached for the capture stream (a warm-up call there), else the call
raises rather than allocate inside the capture.

Buffer layout (logical widths, no lane padding; see the kernel's header):
densenet writes every layer into its column slot of one ``(M, d0 + L*U)``
buffer, which is returned (and, on the register tile, layer i's output
transposed into rows ``[d0 + i*U, d0 + (i+1)*U)`` of the scratch
``stream^T``, which is not kept for autograd); mlp and d2rl alternate
between two ``(M, U)`` buffers, and d2rl hands the kernel its input as the
segments ``[h | x]``, the order of the weight's logical rows.
"""
from __future__ import annotations

import copy
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
RT_HEADER = _CSRC / "dense_tile_rt.cuh"
# (BM, BN, BK) per kernel config id — must match dense_layer_fwd's switch
_CONFIGS = ((16, 64, 32), (32, 64, 32), (64, 64, 16))
# split K until the grid holds about this many blocks per SM
_BLOCKS_PER_SM = 2
# ... but give each split at least this many BK chunks
_MIN_CHUNKS_PER_SPLIT = 4
# the backward's register-tiled tiles (BM, BN, BK) by config id, mirrored
# by dense_tile_rt.cuh's launch_config
_RT_CONFIGS = {3: (128, 128, 8), 4: (128, 64, 8)}
# the register tile takes outputs of at least this many rows and columns
# and reductions at least this long; smaller products keep _CONFIGS
_RT_MIN = 128
# ... and gives each split at least this many BK chunks
_RT_MIN_CHUNKS_PER_SPLIT = 8
# what a split of dx costs, in BK chunks of one block's work: its partials
# written, read back and summed by the tile's last block (fit to the split
# sweeps of launch/bwd_sweep.py at the four dx products, M=256, H100)
_RT_SPLIT_CHUNKS = 6.7
# the forward's register tile: 128x64 tiles only (launch/bwd_sweep.py's
# forward rows, the actor's and the critic's layers at M=256, H100: 128x128
# lost at each), and at least this many BK chunks a split
_RT_FWD_CONFIG = 4
_RT_FWD_MIN_CHUNKS = 16
# act_grad_kernel's row blocks: rows of per-block column sums for db
_ACT_ROW_BLOCKS = 8
# the forward's weight-streaming kernel (dense_stack_fwd.cu stream_kernel):
# its config id, the rows it takes, its blocks' 128-column strips, the K
# rows of A a block holds in shared memory (kMaxK) and the fewest it is
# given (four for each warp of a K part of eight)
_STREAM_CONFIG = 5
_STREAM_MAX_ROWS = 32
_STREAM_COLS = 128
_STREAM_MAX_K = 192
_STREAM_MIN_K = 32
# the forward's whole-stack kernel (dense_stack_fwd.cu whole_stack_kernel):
# narrow densenet stacks (U < _RT_MIN) at any M in one launch; its config
# id, the rows of a block and the row tiles it has, and its shared-memory
# layout (the W ring's stages of _WHOLE_CHUNK rows, the threads whose
# K-group sums it keeps) within the card's 227 KB a block
_WHOLE_CONFIG = 6
_WHOLE_ROWS = 4
_WHOLE_ROW_TILES = (4, 8, 16)
_WHOLE_MAX_LAYERS = 16
_WHOLE_CHUNK = 32
_WHOLE_STAGES = 6
_WHOLE_THREADS = 256
_SMEM_MAX = 232448
# forward kernels by the name their launch counts go under
FWD_KERNELS = ("stream", "rt", "tile", "whole")

_count_lock = threading.Lock()
_launches = dict.fromkeys(FWD_KERNELS, 0)
_transposes = 0
_bwd_launches = 0


def launch_count(kernel: Optional[str] = None) -> int:
    """Forward kernel launches since the last ``reset_launch_count``: of
    every forward kernel (one per layer of every stack forward that ran on
    the card, or one per stack on the whole-stack kernel), or of one of
    ``FWD_KERNELS``: ``"stream"`` (the weight-streaming kernel, M <= 32),
    ``"rt"`` (the register tile), ``"tile"`` (``dense_tile.cuh``) or
    ``"whole"`` (the whole narrow densenet stack in one launch)."""
    if kernel is None:
        return sum(_launches.values())
    return _launches[kernel]


def fwd_kernel_of(config: int) -> str:
    """The name in ``FWD_KERNELS`` of the forward kernel that runs a plan's
    ``config``."""
    if config == _STREAM_CONFIG:
        return "stream"
    if config == _WHOLE_CONFIG:
        return "whole"
    return "rt" if config in _RT_CONFIGS else "tile"


def transpose_count() -> int:
    """``dense_fwd_stream_init`` launches since the last
    ``reset_launch_count``: one per stack forward on the register tile (x
    into the stream and into ``stream^T``)."""
    return _transposes


def bwd_launch_count() -> int:
    """Backward calls on the card since the last ``reset_launch_count``
    (one per stack backward; each launches the kernels of
    ``dense_stack_bwd.cu`` for every layer it reaches)."""
    return _bwd_launches


def reset_launch_count() -> None:
    global _transposes, _bwd_launches
    with _count_lock:
        _launches.update(dict.fromkeys(FWD_KERNELS, 0))
        _transposes = 0
        _bwd_launches = 0


def _count_launch(kind: str) -> None:
    """One launch of a forward kernel (``FWD_KERNELS``), of
    ``"transpose"`` or of ``"bwd"``."""
    global _transposes, _bwd_launches
    with _count_lock:
        if kind == "bwd":
            _bwd_launches += 1
        elif kind == "transpose":
            _transposes += 1
        else:
            _launches[kind] += 1


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

def _concat_loop(x: torch.Tensor, ws, bs, connectivity: str, acts):
    """The concat loop with layer i's activation ``acts[i]``."""
    stream, h = x, x
    for i, (w, b) in enumerate(zip(ws, bs)):
        if connectivity == "densenet":
            inp = stream
        elif connectivity == "d2rl" and i > 0:
            inp = torch.cat([h, x], dim=-1)
        else:
            inp = h
        h = acts[i](inp @ w + b)
        if connectivity == "densenet":
            stream = torch.cat([stream, h], dim=-1)
    return stream if connectivity == "densenet" else h


def dense_stack_ref(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    bs: Sequence[torch.Tensor], *,
                    connectivity: str = "densenet",
                    activation: str = "swish") -> torch.Tensor:
    """The concat loop of ``stack.py::dense_stack_ref``, on 2-D ``x``."""
    return _concat_loop(x, ws, bs, connectivity,
                        [get_activation(activation)] * len(ws))


def dense_stack_grads_ref(x: torch.Tensor, ws: Sequence[torch.Tensor],
                          bs: Sequence[torch.Tensor], g: torch.Tensor, *,
                          connectivity: str = "densenet",
                          activation: str = "swish",
                          zs: Optional[torch.Tensor] = None):
    """``(dx, dws, dbs)`` of ``<dense_stack_ref(x, ws, bs), g>``: autograd of
    the plain version, the reference the backward kernel is held against.

    With ``zs`` (a forward's pre-activations, ``(M, L*U)``), relu's
    derivative is taken at their signs. Relu has a kink at 0: a
    pre-activation within rounding of 0 gets slope 0 from one forward and 1
    from another, and the gradients then differ by a whole row of g. Taking
    the slope at the kernel forward's own pre-activations holds the
    backward to the tolerance; the forward is held on its own."""
    n = len(ws)
    acts = [get_activation(activation)] * n
    if zs is not None and activation == "relu":
        u = ws[0].shape[1]
        acts = [lambda z, on=(zs[:, i * u:(i + 1) * u] > 0): z * on
                for i in range(n)]
    with torch.enable_grad():
        var = [t.detach().requires_grad_(True) for t in (x, *ws, *bs)]
        out = _concat_loop(var[0], var[1:1 + n], var[1 + n:], connectivity,
                           acts)
        grads = torch.autograd.grad(out, var, g)
    return grads[0], list(grads[1:1 + n]), list(grads[1 + n:])


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_fwd", [SOURCE], [HEADER, RT_HEADER])
    if lib.dense_layer_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dense_layer_fwd.argtypes = [i, p, ll, i, p, ll, i, p, p, p, ll,
                                        p, ll, p, p, i, i, i, i, i, p]
        lib.dense_layer_fwd_rt.argtypes = [i, i, p, ll, p, ll, p, p, ll, p,
                                           ll, p, ll, p, p, i, i, i, i, i,
                                           i, p]
        lib.dense_layer_fwd_stream.argtypes = [i, p, ll, i, p, ll, i, p, ll,
                                               p, p, ll, p, ll, p, ll, p, p,
                                               i, i, i, i, i, p]
        lib.dense_fwd_stream_init.argtypes = [p, ll, p, ll, p, ll, i, i, p]
        lib.dense_stack_fwd_whole.argtypes = [i, i, p, ll, i, p, p, i, i, p,
                                              ll, p, ll, i, i, p]
        for fn in (lib.dense_layer_fwd, lib.dense_layer_fwd_rt,
                   lib.dense_layer_fwd_stream, lib.dense_fwd_stream_init,
                   lib.dense_stack_fwd_whole):
            fn.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_bwd", [BWD_SOURCE], [HEADER, RT_HEADER])
    if lib.dense_bwd_gemm.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dense_bwd_act_grad.argtypes = [p, ll, p, ll, p, p, ll, p, i, i,
                                           i, p]
        lib.dense_bwd_db.argtypes = [p, p, i, p]
        lib.dense_bwd_act.argtypes = [p, ll, p, i, i, i, p]
        lib.dense_bwd_transpose.argtypes = [p, ll, p, ll, i, i, p]
        lib.dense_bwd_gemm.argtypes = [i, i, i, p, ll, i, p, ll, i, p, ll,
                                       p, ll, i, p, p, i, i, i, i, p]
        lib.dense_bwd_gemm_rt.argtypes = [i, i, i, p, ll, p, ll, p, ll, p,
                                          ll, p, p, i, i, i, i, i, p]
        for fn in (lib.dense_bwd_act_grad, lib.dense_bwd_db,
                   lib.dense_bwd_act, lib.dense_bwd_transpose,
                   lib.dense_bwd_gemm, lib.dense_bwd_gemm_rt):
            fn.restype = ctypes.c_int
    return lib


def plan(m: int, n: int, k: int, num_sms: int) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, chunks_per_split)`` of one
    ``dense_tile.cuh`` product with an ``(m, n)`` output and a reduction of
    length ``k``.

    The tile config follows the rows: the thin row tiles of configs 0 and 1
    serve the backward's products of up to 32 rows; the forward takes this
    plan only past 32 rows (``plan_fwd``), so always config 2. K is split
    so the grid holds ~``_BLOCKS_PER_SM`` blocks per SM even when the
    output has few tiles."""
    config = 0 if m <= 16 else 1 if m <= 32 else 2
    bm, bn, bk = _CONFIGS[config]
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    want = -(-_BLOCKS_PER_SM * num_sms // tiles)
    splits = max(1, min(want, chunks // _MIN_CHUNKS_PER_SPLIT))
    per_split = -(-chunks // splits)
    return config, tiles, -(-chunks // per_split), per_split


def plan_bwd(m: int, n: int, k: int, num_sms: int,
             config: Optional[int] = None, dx: bool = False,
             vec: bool = True) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, chunks_per_split)`` of one backward product
    with an ``(m, n)`` output and a reduction of length ``k``: dW (the
    reduction over the batch) or, with ``dx``, the input gradient (over U).

    Outputs of at least ``_RT_MIN`` rows and columns with a reduction at
    least as long take a register-tiled config of ``_RT_CONFIGS``
    (``config`` forces one); smaller products (the narrow OFENet stacks,
    small test shapes) keep the forward's ``plan``. The rules follow the
    card (``launch/bwd_sweep.py``: both tiles and every split at the
    critic's and the actor's products, H100):

    * dW reduces over only the batch, and its output is large: 128x128
      tiles where they are one wave or more and ``vec`` (the stream takes
      16-byte copies), else 128x64; no split unless the tiles fill less
      than half the SMs (a split writes and rereads the whole output).
    * dx reduces over U = 2048 into a small output, so K is split. Its
      blocks stream W^T from device memory, and a second block on an SM
      added nothing, so the plan counts waves of one block per SM: it
      takes 128x64 tiles and the split that minimises waves x chunks per
      split + splits x ``_RT_SPLIT_CHUNKS``; ties go to fewer splits."""
    if min(m, n, k) < _RT_MIN:
        if config is not None:
            raise ValueError(f"config {config} forced on a ({m}, {n}) x "
                             f"{k} product below the register tile")
        return plan(m, n, k, num_sms)
    if config is not None and config not in _RT_CONFIGS:
        raise ValueError(f"config {config} is not a register-tiled config "
                         f"{tuple(_RT_CONFIGS)}")

    def tiles_of(cfg):
        bm, bn, _ = _RT_CONFIGS[cfg]
        return -(-m // bm) * -(-n // bn)

    if config is None:
        config = 3 if not dx and vec and tiles_of(3) >= num_sms else 4
    tiles, bk = tiles_of(config), _RT_CONFIGS[config][2]
    chunks = -(-k // bk)
    max_splits = max(1, chunks // _RT_MIN_CHUNKS_PER_SPLIT)
    if not dx:
        want = -(-num_sms // tiles) if 2 * tiles < num_sms else 1
        per_split = -(-chunks // min(want, max_splits))
        return config, tiles, -(-chunks // per_split), per_split
    best = None
    for want in range(1, max_splits + 1):
        per_split = -(-chunks // want)
        splits = -(-chunks // per_split)
        cost = -(-tiles * splits // num_sms) * per_split \
            + _RT_SPLIT_CHUNKS * (splits - 1)
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), (config, tiles, splits, per_split))
    return best[1]


def whole_smem(d0: int, u: int, n_layers: int,
               rows: int = _WHOLE_ROWS) -> Optional[int]:
    """Bytes of dynamic shared memory the whole-stack kernel takes for a
    densenet stack (input width ``d0``, ``n_layers`` layers of ``u``) at
    ``rows`` rows a block, or None where it does not take the stack (U of
    ``_RT_MIN`` or more, more than ``_WHOLE_MAX_LAYERS`` layers, or more
    than the 227 KB a block may have): the block's rows of the stream
    below the last layer, transposed; the W ring (``_WHOLE_STAGES`` stages
    of ``_WHOLE_CHUNK`` rows of U rounded up to 64 or 128 columns); one
    sum per row for each thread (dense_stack_fwd.cu ``whole::smem_bytes``).
    """
    if u >= _RT_MIN or not 1 <= n_layers <= _WHOLE_MAX_LAYERS:
        return None
    cols = 64 if u <= 64 else 128
    size = 4 * ((d0 + (n_layers - 1) * u) * rows
                + _WHOLE_STAGES * _WHOLE_CHUNK * cols + _WHOLE_THREADS * rows)
    return size if size <= _SMEM_MAX else None


def plan_fwd(m: int, n: int, k: int, num_sms: int,
             transposed: bool = True,
             stack: Optional[Tuple[int, int]] = None
             ) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, per_split)`` of one forward layer with an
    ``(m, n)`` output and a reduction of length ``k``; ``stack`` is the
    layer's densenet stack ``(d0, layers)`` where the caller can run it
    whole:

    * a narrow densenet stack (U < ``_RT_MIN``; ``stack`` given, with
      ``transposed``) whose ``whole_smem`` fits, at any M: the whole-stack
      kernel (``_WHOLE_CONFIG``), one launch for every layer, blocks of
      ``_WHOLE_ROWS`` rows (``tiles`` counts them, ``per_split`` is the
      rows; no split). The OFENet stacks in training and serving: the card
      sweep (``launch/bwd_sweep.py``, H100) found it faster than the
      per-layer kernels at every row count it timed (1, 8, 32, 256) and 4
      rows a block the best of 4, 8 and 16.
    * up to ``_STREAM_MAX_ROWS`` rows (the serving slots, the actor pool's
      collect), the weight-streaming kernel (``_STREAM_CONFIG``). Bytes
      bind it: its tiles are 128-column strips, and K is split so the grid
      holds up to ``_BLOCKS_PER_SM`` blocks per SM, one wave (a block past
      it waits for a whole block's time), in parts of at least
      ``_STREAM_MIN_K`` and at most ``_STREAM_MAX_K`` rows (``per_split``
      counts rows here, not chunks).
    * at least ``_RT_MIN`` rows and columns where the wrapper keeps the
      stream transposed (``transposed``: densenet), the register tile's
      128x64 tiles (``_RT_FWD_CONFIG``) with K split into up to
      ``_BLOCKS_PER_SM`` blocks per SM, each with at least
      ``_RT_FWD_MIN_CHUNKS`` chunks. The rules follow the card
      (``launch/bwd_sweep.py``: the actor's and the critic's layers at
      M=256, H100): a second block per SM hides the first one's loads
      (the actor's layer 1: 84.4 us at 4 splits, 94.0 at 2), and a short K
      keeps fewer splits.
    * otherwise (mlp and d2rl past 32 rows, a densenet stack too wide for
      the whole-stack kernel), ``dense_tile.cuh`` as ``plan`` plans it
      (config 2)."""
    if transposed and stack is not None and whole_smem(
            stack[0], n, stack[1]) is not None:
        return _WHOLE_CONFIG, -(-m // _WHOLE_ROWS), 1, _WHOLE_ROWS
    if m <= _STREAM_MAX_ROWS:
        strips = -(-n // _STREAM_COLS)
        want = max(1, _BLOCKS_PER_SM * num_sms // strips)
        splits = max(-(-k // _STREAM_MAX_K),
                     min(want, max(1, k // _STREAM_MIN_K)))
        per_split = -(-k // splits)
        return _STREAM_CONFIG, strips, -(-k // per_split), per_split
    if not (transposed and min(m, n) >= _RT_MIN):
        return plan(m, n, k, num_sms)
    bm, bn, bk = _RT_CONFIGS[_RT_FWD_CONFIG]
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    splits = max(1, min(_BLOCKS_PER_SM * num_sms // tiles,
                        chunks // _RT_FWD_MIN_CHUNKS))
    per_split = -(-chunks // splits)
    return _RT_FWD_CONFIG, tiles, -(-chunks // per_split), per_split


def vec_aligned(*operands: Tuple[int, int]) -> bool:
    """True when every ``(address, row stride in floats)`` operand takes
    16-byte loads: the address a multiple of 16 bytes, the stride of 4
    floats. The register tile copies each operand 16 bytes at a time where
    this holds for it, single floats elsewhere."""
    return all(ptr % 16 == 0 and ld % 4 == 0 for ptr, ld in operands)


def operand(t: torch.Tensor, col: int = 0) -> Tuple[int, int]:
    """``(address, row stride)`` of a float32 tensor from column ``col``
    of its row 0: one operand of ``vec_aligned``."""
    return t.data_ptr() + 4 * col, t.stride(0)


_state_lock = threading.Lock()      # guards the two dicts below
_counter_bufs: dict = {}
_side_streams: dict = {}


def _no_capture(cache: str) -> None:
    """Raise where a cache would be filled while a CUDA graph captures:
    its buffer or stream would be made inside the graph. A warm-up call on
    the capture stream fills the caches first. (No capture is underway
    before CUDA is initialized; the CPU tests call the caches without it.)"""
    if torch.cuda.is_initialized() and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{cache}: cache miss while a CUDA graph captures the current "
            f"stream; run the captured work once on the capture stream "
            f"before capturing it")


def _tile_counters(n: int, dev: torch.device, stream: int) -> torch.Tensor:
    """``n`` zeroed int32 counters for a backward launch on ``stream``.

    One buffer per (device, stream), filled with zeros only when it is made
    or grown: every backward kernel resets the counters it used to 0 before
    it exits, and launches on one stream run in order, so the next launch
    finds them zeroed."""
    key = (dev, stream)
    with _state_lock:
        buf = _counter_bufs.get(key)
        if buf is None or buf.numel() < n:
            _no_capture("_tile_counters")
            size = max(n, 1024, 0 if buf is None else 2 * buf.numel())
            buf = torch.zeros((size,), device=dev, dtype=torch.int32)
            _counter_bufs[key] = buf
        return buf


def _side_stream(dev: torch.device, main: torch.cuda.Stream
                 ) -> torch.cuda.Stream:
    """The stream a backward on ``main`` runs its db, dW and W^T work on:
    one per (device, main stream), made at first use."""
    key = (dev, main.cuda_stream)
    with _state_lock:
        side = _side_streams.get(key)
        if side is None:
            _no_capture("_side_stream")
            side = _side_streams[key] = torch.cuda.Stream(device=dev)
        return side


def _ptr(t: Optional[torch.Tensor], col: int = 0):
    """Address of column ``col`` of row 0 of a float32 tensor (or None)."""
    return None if t is None else t.data_ptr() + 4 * col


def _device_info(dev: torch.device) -> Tuple[int, int]:
    """``(SM count, current stream handle)`` of a CUDA device."""
    return (torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)


def _launch_layer(lib, plan, seg1: Tuple[torch.Tensor, int],
                  seg2: Optional[Tuple[torch.Tensor, int]],
                  w: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                  col: int, act: int, stream: int,
                  z: Optional[Tuple[torch.Tensor, int]] = None,
                  at: Optional[torch.Tensor] = None,
                  yt: Optional[torch.Tensor] = None,
                  acopy: Optional[torch.Tensor] = None) -> None:
    """``out[:, col:col+N] = act([seg1 | seg2] @ w + b)`` by the kernel of
    ``plan`` (``plan_fwd``'s); a segment is ``(tensor, first column)`` and
    spans ``w``'s matching rows. ``z`` ``(tensor, first column)`` receives
    the pre-activation when given. The register tile reads the stream from
    ``at`` (``stream^T``, rows padded to 4 floats) instead of ``seg1`` and
    writes its output transposed into ``yt`` (rows of ``stream^T``) when
    given. The streaming kernel also copies ``seg1``'s columns into the
    first columns of ``acopy`` when given (x into densenet's stream)."""
    config, tiles, splits, per_split = plan
    a1, c1 = seg1
    m, n = out.shape[0], w.shape[1]
    k2 = 0 if seg2 is None else seg2[0].shape[1] - seg2[1]
    k1 = w.shape[0] - k2
    kind = fwd_kernel_of(config)
    ws_buf = counters = None
    if splits > 1:
        ws_buf = torch.empty((splits, m, _pad4(n) if kind != "tile" else n),
                             device=out.device, dtype=torch.float32)
        counters = _tile_counters(tiles, out.device, stream)
    z_ptr, ldz = (None, 0) if z is None else (_ptr(*z), z[0].stride(0))
    vec_w = int(vec_aligned(operand(w)))
    if kind == "rt":
        err = lib.dense_layer_fwd_rt(
            config, vec_w, at.data_ptr(), at.stride(0), w.data_ptr(),
            w.stride(0), b.data_ptr(), _ptr(out, col), out.stride(0), z_ptr,
            ldz, _ptr(yt), 0 if yt is None else yt.stride(0), _ptr(ws_buf),
            _ptr(counters), m, n, k1, act, splits, per_split, stream)
    else:
        a2_ptr, lda2 = None, 0
        if seg2 is not None:
            a2_ptr, lda2 = _ptr(*seg2), seg2[0].stride(0)
        if kind == "stream":
            err = lib.dense_layer_fwd_stream(
                vec_w, _ptr(a1, c1), a1.stride(0), k1, a2_ptr, lda2, k2,
                w.data_ptr(), w.stride(0), b.data_ptr(), _ptr(out, col),
                out.stride(0), z_ptr, ldz, _ptr(acopy),
                0 if acopy is None else acopy.stride(0), _ptr(ws_buf),
                _ptr(counters), m, n, act, splits, per_split, stream)
        else:
            err = lib.dense_layer_fwd(
                config, _ptr(a1, c1), a1.stride(0), k1, a2_ptr, lda2, k2,
                w.data_ptr(), b.data_ptr(), _ptr(out, col), out.stride(0),
                z_ptr, ldz, _ptr(ws_buf), _ptr(counters), m, n, act, splits,
                per_split, stream)
    if err != 0:
        raise RuntimeError(f"dense_stack forward ({kind}) launch failed: "
                           f"CUDA error {err} (m={m}, n={n}, k={k1 + k2}, "
                           f"config={config}, splits={splits})")
    _count_launch(kind)


def _launch_whole(lib, x: torch.Tensor, ws, bs, out: torch.Tensor,
                  zs: Optional[torch.Tensor], act: int, rows: int,
                  stream: int) -> None:
    """A whole densenet stack in one launch of the whole-stack kernel at
    ``rows`` rows a block: x into ``out``'s first columns, y_i into its
    slots, z_i into ``zs``'s when given."""
    (m, d0), n_layers, u = x.shape, len(ws), ws[0].shape[1]
    vec_w = int(vec_aligned(*(operand(w) for w in ws)))
    err = lib.dense_stack_fwd_whole(
        rows, vec_w, x.data_ptr(), x.stride(0), n_layers,
        (ctypes.c_longlong * n_layers)(*(w.data_ptr() for w in ws)),
        (ctypes.c_longlong * n_layers)(*(b.data_ptr() for b in bs)),
        d0, u, out.data_ptr(), out.stride(0), _ptr(zs),
        0 if zs is None else zs.stride(0), m, act, stream)
    if err != 0:
        raise RuntimeError(f"dense_stack forward (whole) launch failed: CUDA "
                           f"error {err} (m={m}, d0={d0}, u={u}, layers="
                           f"{n_layers}, rows={rows})")
    _count_launch("whole")


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
                    activation: str, zs: Optional[torch.Tensor] = None,
                    whole: bool = True) -> torch.Tensor:
    """The stack's feature; with ``zs`` (``(M, L*U)``), layer i also stores
    its pre-activation into columns ``[i*U, (i+1)*U)``. ``whole=False``
    keeps a narrow densenet stack on the per-layer kernels (what the card
    sweep compares the whole-stack kernel with)."""
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
        num_sms, stream = _device_info(dev)

        def z_slot(i):
            return None if zs is None else (zs, i * u)
        if connectivity == "densenet":
            out = torch.empty((m, out_w), device=dev, dtype=torch.float32)
            plans = [plan_fwd(m, u, d0 + i * u, num_sms,
                              stack=(d0, n_layers) if whole else None)
                     for i in range(n_layers)]
            if plans[0][0] == _WHOLE_CONFIG:    # every layer alike: m, u
                _launch_whole(lib, x, ws, bs, out, zs, act, plans[0][3],
                              stream)
                return out
            st = None                   # stream^T: x^T, y_0^T .. y_{L-2}^T
            if plans[0][0] in _RT_CONFIGS:      # every layer alike: m, u
                st = torch.empty((d0 + (n_layers - 1) * u, _pad4(m)),
                                 device=dev, dtype=torch.float32)
                err = lib.dense_fwd_stream_init(
                    x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
                    st.data_ptr(), st.stride(0), m, d0, stream)
                if err != 0:
                    raise RuntimeError(f"dense_fwd_stream_init launch failed:"
                                       f" CUDA error {err} (m={m}, d0={d0})")
                _count_launch("transpose")
            elif plans[0][0] != _STREAM_CONFIG:
                out[:, :d0].copy_(x)
            for i in range(n_layers):
                d = d0 + i * u
                yt = st[d:d + u] if st is not None and i < n_layers - 1 \
                    else None
                # the streaming kernel's layer 0 reads x and copies it in
                first = i == 0 and plans[0][0] == _STREAM_CONFIG
                _launch_layer(lib, plans[i], (x, 0) if first else (out, 0),
                              None, ws[i], bs[i], out, d, act, stream,
                              z_slot(i), st, yt, out if first else None)
            return out
        bufs = [torch.empty((m, u), device=dev, dtype=torch.float32)
                for _ in range(min(n_layers, 2))]
        h = x
        for i in range(n_layers):
            dst = bufs[i % 2]
            seg2 = (x, 0) if connectivity == "d2rl" and i > 0 else None
            plan_i = plan_fwd(m, u, ws[i].shape[0], num_sms, transposed=False)
            _launch_layer(lib, plan_i, (h, 0), seg2, ws[i], bs[i], dst, 0,
                          act, stream, z_slot(i))
            h = dst
        return h


def _pad4(n: int) -> int:
    """n rounded up to a multiple of 4 (a 16-byte row of float32)."""
    return n + -n % 4


class _Backward:
    """One stack backward on the card: the launches of
    ``dense_stack_bwd.cu`` (see its header), layer by layer in reverse."""

    def __init__(self, m: int, u: int, activation: str, dev: torch.device):
        self.lib = _bwd_library()
        self.m, self.u, self.dev = m, u, dev
        self.act = _ACT_CODE[activation]
        self.num_sms, self.stream = _device_info(dev)

    def _empty(self, *shape) -> torch.Tensor:
        return torch.empty(shape, device=self.dev, dtype=torch.float32)

    def _counters(self, n: int) -> torch.Tensor:
        return _tile_counters(n, self.dev, self.stream)

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")

    def dx_rt(self, k: int) -> bool:
        """Whether ``dinput`` of width k takes the register tile (and so
        needs gz^T from ``act_grad``)."""
        return plan_bwd(self.m, k, self.u, self.num_sms,
                        dx=True)[0] in _RT_CONFIGS

    def on(self, stream: torch.cuda.Stream) -> "_Backward":
        """The same backward, launching on ``stream``."""
        other = copy.copy(self)
        other.stream = stream.cuda_stream
        return other

    def act_grad(self, g: torch.Tensor, gcol: int, zs: torch.Tensor,
                 i: int, need_db: bool, transpose: bool = False):
        """``(gz, gzt, db_part)`` of layer i: ``gz = g[:, gcol:gcol+U] *
        act'(z_i)``; with ``transpose`` gz^T (U, M) for the register-tiled
        dx products (else None); with ``need_db`` the per-row-block column
        sums that ``db`` adds up (else None)."""
        gz = self._empty(self.m, self.u)
        gzt = self._empty(self.u, _pad4(self.m))[:, :self.m] if transpose \
            else None
        part = self._empty(_ACT_ROW_BLOCKS, self.u) if need_db else None
        self._check(self.lib.dense_bwd_act_grad(
            _ptr(g, gcol), g.stride(0), _ptr(zs, i * self.u), zs.stride(0),
            gz.data_ptr(), _ptr(gzt), 0 if gzt is None else gzt.stride(0),
            _ptr(part), self.m, self.u, self.act, self.stream),
            "dense_bwd_act_grad")
        return gz, gzt, part

    def db(self, part: torch.Tensor, db: torch.Tensor) -> None:
        """``db`` = the rows of ``act_grad``'s sums added in order."""
        self._check(self.lib.dense_bwd_db(part.data_ptr(), db.data_ptr(),
                                          self.u, self.stream), "dense_bwd_db")

    def act_of(self, zs: torch.Tensor, i: int) -> torch.Tensor:
        """``act(z_i)``: layer i's output, for mlp/d2rl."""
        h = self._empty(self.m, self.u)
        self._check(self.lib.dense_bwd_act(
            _ptr(zs, i * self.u), zs.stride(0), h.data_ptr(), self.m,
            self.u, self.act, self.stream), "dense_bwd_act")
        return h

    def transpose(self, t: torch.Tensor) -> torch.Tensor:
        """``t^T`` of a 2-D float32 view with unit column stride, rows
        padded to 4 floats."""
        rows, cols = t.shape
        out = self._empty(cols, _pad4(rows))[:, :rows]
        self._check(self.lib.dense_bwd_transpose(
            t.data_ptr(), t.stride(0), out.data_ptr(), out.stride(0), rows,
            cols, self.stream), "dense_bwd_transpose")
        return out

    def _product(self, plan, dx: bool, a_op, b_op, out: torch.Tensor,
                 ocol: int, orow: int, m: int, n: int, k: int,
                 accumulate: bool, add=None) -> None:
        """``out[orow:, ocol:]`` (m, n) (+)= a product over k, or = ``add`` +
        the product (register tile only). Register tile: ``a^T @ b`` with a
        (k, m) and b (k, n); dense_tile.cuh: dW as ``a^T @ b`` likewise, dx
        as ``a @ b^T`` with a (m, k) and b (n, k). Operands, ``add`` too,
        are ``(address, row stride)``."""
        config, tiles, splits, per_split = plan
        rt = config in _RT_CONFIGS
        ws_buf = counters = None
        if splits > 1:
            ws_buf = self._empty(splits, m, _pad4(n) if rt else n)
            counters = self._counters(tiles)
        out_ptr = _ptr(out, orow * out.stride(0) + ocol)
        if rt:
            vec = int(vec_aligned(a_op)) | 2 * int(vec_aligned(b_op))
            if add is None:
                add = (out_ptr, out.stride(0)) if accumulate else (None, 0)
            err = self.lib.dense_bwd_gemm_rt(
                config, int(dx), vec, *a_op, *b_op, out_ptr, out.stride(0),
                *add, _ptr(ws_buf), _ptr(counters), m, n, k, splits,
                per_split, self.stream)
        else:
            if add is not None:
                raise ValueError("dense_tile.cuh adds in place only")
            err = self.lib.dense_bwd_gemm(
                config, int(not dx), int(dx), *a_op, k, None, 0, 0, *b_op,
                out_ptr, out.stride(0), int(accumulate), _ptr(ws_buf),
                _ptr(counters), m, n, splits, per_split, self.stream)
        self._check(err, f"dense_bwd_gemm (config {config}, m={m}, n={n}, "
                         f"k={k}, splits={splits})")

    def dw(self, inp: torch.Tensor, col: int, k: int, gz: torch.Tensor,
           dw: torch.Tensor, row: int, config: Optional[int] = None) -> None:
        """``dw[row:row+k] = inp[:, col:col+k]^T @ gz`` (reduces the batch)."""
        a_op = operand(inp, col)
        plan = plan_bwd(k, self.u, self.m, self.num_sms, config,
                        vec=vec_aligned(a_op))
        self._product(plan, False, a_op, operand(gz), dw, 0, row, k, self.u,
                      self.m, False)

    def dinput(self, gz: torch.Tensor, gzt: Optional[torch.Tensor],
               w: torch.Tensor, row: int, k: int, out: torch.Tensor,
               col: int, accumulate: bool, config: Optional[int] = None,
               wt: Optional[torch.Tensor] = None, add=None) -> None:
        """``out[:, col:col+k] (+)= gz @ w[row:row+k]^T`` (reduces U), or =
        ``add`` + the product. The register tile reads ``gzt`` (gz^T from
        ``act_grad``) and W's rows transposed (``wt`` if already made, else
        made here), both padded to 16-byte rows, so both operands run along
        the output."""
        plan = plan_bwd(self.m, k, self.u, self.num_sms, config, dx=True)
        # a and b stay referenced until the launch is queued: the allocator
        # would hand a freed W^T to the split workspace of this very launch
        a, b = gz, w[row:row + k]
        if plan[0] in _RT_CONFIGS:
            a, b = gzt, self.transpose(b) if wt is None else wt
        self._product(plan, True, operand(a), operand(b), out, col, 0,
                      self.m, k, self.u, accumulate, add)


def _kernel_backward(saved, ws, g: torch.Tensor, connectivity: str,
                     activation: str, need_dx: bool, need_dw, need_db):
    """``(dx, dws, dbs)`` on the card, None where not asked for. ``saved``
    is the forward's output stream (densenet) or its input ``x`` (mlp,
    d2rl), then the pre-activations ``zs``.

    The chain act_grad_i -> dx_i -> act_grad_{i-1} runs on the caller's
    stream. Off it, on a side stream: (densenet) every W_i^T the dx
    products read, up front, then each db_i and dW_i, which need only
    act_grad_i's outputs; they run at once with the chain, on the SMs it
    leaves idle.
    Tensors that one stream makes and the other uses are recorded for it,
    so the allocator does not hand their memory out while it is still in
    use; the caller's stream waits for the side stream before the
    gradients are returned."""
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
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev, main)
        bw = _Backward(m, u, activation, dev)
        bws = bw.on(side)
        g = g.contiguous()

        def off_chain(i, gz, part, segments):
            """db_i and dW_i on the side stream, once the caller's stream
            has made gz and the row sums: dW's rows from each ``(input,
            first row)`` segment."""
            dbs[i] = bw._empty(u) if part is not None else None
            if segments:
                dws[i] = bw._empty(ws[i].shape[0], u)
            side.wait_stream(main)
            for t in (gz, part, dbs[i], dws[i], *(t for t, _ in segments)):
                if t is not None:
                    t.record_stream(side)
            with torch.cuda.stream(side):
                if part is not None:
                    bws.db(part, dbs[i])
                for inp, row in segments:
                    bws.dw(inp, 0, inp.shape[1], gz, dws[i], row)

        if connectivity == "densenet":
            # gb, the gradient stream below the top slot, accumulated in
            # place; its row stride is rounded up to 4 floats, so the dx
            # products store 16 bytes at a time whatever the stream's width
            # (the actor's is 4355). Where the top layer's dx takes the
            # register tile, it writes gb = g's prefix + its product, and g
            # is not copied; where the bottom one does, it writes dx = gb's
            # prefix + its product, and gb's prefix is not copied out.
            top = n_layers - 1
            k_top = d0 + top * u
            from_g = (top > lowest or need_dx) and bw.dx_rt(k_top)
            width = k_top if from_g else g.shape[1]
            gb = torch.empty((m, _pad4(width)), device=dev,
                             dtype=torch.float32)[:, :width]
            if not from_g:
                gb.copy_(g)
            dx = torch.empty((m, d0), device=dev) \
                if need_dx and bw.dx_rt(d0) else None
            # every W_i^T dx will read, made up front on the side stream,
            # top layer first: off the chain, which waits only for its own
            wts, ready = {}, {}
            side.wait_stream(main)          # W may still be being written
            with torch.cuda.stream(side):
                for i in reversed(range(lowest, n_layers)):
                    if (i > lowest or need_dx) and bw.dx_rt(d0 + i * u):
                        wts[i] = bws.transpose(ws[i])
                        wts[i].record_stream(main)
                        ready[i] = torch.cuda.Event()
                        ready[i].record(side)
            for i in reversed(range(lowest, n_layers)):
                k = d0 + i * u
                g_in = i > lowest or need_dx
                src = g if i == top and from_g else gb
                gz, gzt, part = bw.act_grad(src, k, zs, i, need_db[i],
                                            g_in and bw.dx_rt(k))
                off_chain(i, gz, part,
                          [(stream_or_x[:, :k], 0)] if need_dw[i] else [])
                if g_in:
                    if i in wts:
                        main.wait_event(ready[i])
                    out = dx if i == 0 and dx is not None else gb
                    bw.dinput(gz, gzt, ws[i], 0, k, out, 0, accumulate=True,
                              wt=wts.pop(i, None),
                              add=None if src is out else operand(src))
            if need_dx and dx is None:
                dx = gb[:, :d0].contiguous()
        else:
            x = stream_or_x
            d2rl = connectivity == "d2rl"
            gh = g
            gx = torch.zeros((m, d0), device=dev) if need_dx and d2rl \
                else None
            for i in reversed(range(lowest, n_layers)):
                inputs = []                  # the input gradients it makes
                if i == 0 and need_dx:
                    if not d2rl:
                        gx = bw._empty(m, d0)
                    inputs.append((0, d0, gx, d2rl))
                elif i > lowest:             # layer i-1 needs gh
                    inputs.append((0, u, bw._empty(m, u), False))
                    if need_dx and d2rl:     # weight rows [h | x]
                        inputs.append((u, d0, gx, True))
                gz, gzt, part = bw.act_grad(
                    gh, 0, zs, i, need_db[i],
                    any(bw.dx_rt(k) for _, k, _, _ in inputs))
                segments = []
                if need_dw[i]:
                    h_prev = bw.act_of(zs, i - 1) if i > 0 else x
                    segments = [(h_prev, 0)] + ([(x, u)] if d2rl and i > 0
                                                else [])
                off_chain(i, gz, part, segments)
                for row, k, out, acc in inputs:
                    bw.dinput(gz, gzt, ws[i], row, k, out, 0, acc)
                if i > lowest:
                    gh = inputs[0][2]
            dx = gx
        main.wait_stream(side)
    _count_launch("bwd")
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
