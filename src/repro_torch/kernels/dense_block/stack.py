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
  (the actor and critic stacks in training, every connectivity), the
  tensor-core tile of ``csrc/dense_tile_tc.cuh`` (3xTF32 on wgmma) over
  the layer's input row-major, rows padded to 4 floats (``_tc_stack``),
  or, where U is not a multiple of 4, the register tile of
  ``csrc/dense_tile_rt.cuh`` over a transposed copy of the layer's input,
  which one ``dense_fwd_stream_init`` launch per call starts (x^T) and
  every layer's epilogue extends (densenet's stream^T; mlp's and d2rl's
  ping-pong buffers of h^T, ``_rt_hidden``); otherwise
  ``csrc/dense_tile.cuh``, once per layer.
  When autograd will differentiate the call, the forward also keeps every
  layer's pre-activation in an ``(M, L*U)`` side buffer, and the backward
  (``_StackKernel.backward``, the port of ``_bwd_kernel``) launches
  ``csrc/dense_stack_bwd.cu``: a narrow densenet stack whose shared memory
  fits (``whole_bwd_smem``: the OFENet stacks) in ONE launch of the
  whole-stack backward kernel, every other stack layer by layer in
  reverse, W^T, dW and db on a side stream beside the act_grad -> dx
  chain; products of at least 128 x 128 x 128 (every one of the actor and
  the critic) take the register tile of ``csrc/dense_tile_rt.cuh`` as
  ``plan_bwd`` plans them.
  It computes only the gradients autograd asks for, and it is bitwise the
  same from run to run (no floating-point atomics).
* On a CPU tensor it runs ``dense_stack_ref``, the plain PyTorch concat
  loop, which autograd differentiates as usual. This is the reference the
  kernels are held against on the card (``dense_stack_grads_ref`` for the
  backward).
* Under a ``torch.func`` transform (a fleet's ``vmap`` of the superstep,
  ``grad_and_value`` inside it) it takes two custom ops,
  ``repro_torch::dense_stack_fwd`` and ``repro_torch::dense_stack_bwd``,
  inside ``_StackFn`` (an autograd function that ``torch.func`` can
  transform). Their ``vmap`` rules run E members at once:
  ``dense_stack_members`` and ``dense_stack_members_grads`` launch every
  kernel once for all members on a CUDA tensor (a member axis,
  ``gridDim.z``, each operand at its member stride, 0 for an operand the
  members share, never copied E times), planned for the E members (the
  tensor-core tile splits K to fill the card with E x tiles blocks), so
  a member is bitwise its solo launches of the same plan; on a CPU tensor
  the members twins
  (``dense_stack_members_ref``, ``dense_stack_members_grads_ref``) loop the
  solo plain version, bitwise a loop of solo calls. The backward computes
  only the gradients the transform asks for (a constant weight's dW is
  skipped). Outside a transform nothing of this route runs.

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
segments ``[h | x]``, the order of the weight's logical rows; on the
register tile they alternate between two slots of h^T instead (d2rl's
each followed by its own x^T, so ``[h | x]^T`` is one operand), and only
the last layer writes the row-major feature.
"""
from __future__ import annotations

import copy
import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.common import get_activation, members_first

FUSED_CONNECTIVITIES = ("mlp", "densenet", "d2rl")
FUSED_ACTIVATIONS = ("swish", "silu", "relu", "tanh", "identity")
_ACT_CODE = {"identity": 0, "relu": 1, "tanh": 2, "swish": 3, "silu": 3}

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "dense_stack_fwd.cu"
BWD_SOURCE = _CSRC / "dense_stack_bwd.cu"
HEADER = _CSRC / "dense_tile.cuh"
RT_HEADER = _CSRC / "dense_tile_rt.cuh"
TC_HEADER = _CSRC / "dense_tile_tc.cuh"
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
# a wide stack's thin backward product (only the layer's input width under
# _RT_MIN) takes the register tile from this input width, its dx unsplit
# below this reduction (launch/bwd_sweep.py --only thin, H100: the
# presets' 35- to 68-wide first layers at M=U=128 11.1-12.7 us against
# dense_tile.cuh's 15.1-17.3, dx 11.6-11.9 unsplit against 12.4-18.1 in
# two; fig3's 4-wide first layer at U=2048 slower on the tile, dW 12.8 us
# against 10.8, dx 35.8 against 13.9)
_RT_THIN_MIN = 32
_RT_THIN_SPLIT_K = 256
# what a split of dx costs, in BK chunks of one block's work: its partials
# written, read back and summed by the tile's last block (fit to the split
# sweeps of launch/bwd_sweep.py at the four dx products, M=256, H100)
_RT_SPLIT_CHUNKS = 6.7
# the forward's register tile: 128x64 tiles only (launch/bwd_sweep.py's
# forward rows, the actor's and the critic's layers at M=256, H100: 128x128
# lost at each), and at least this many BK chunks a split
_RT_FWD_CONFIG = 4
_RT_FWD_MIN_CHUNKS = 16
# the forward's tensor-core tile (dense_tile_tc.cuh, 3xTF32 on wgmma): its
# config id, its (rows, features, K a stage) tile, the fewest K chunks a
# split takes; a block's fixed cost (prologue, epilogue) in K chunks of its
# work, and what each split past the first adds to a block of every wave
# (the partial tile the tile's last block reads back); both fit to the
# split sweep of launch/bwd_sweep.py --only fwd (M=256, U 128-2048, solo
# and 5 members, H100): the plan then takes the fastest split at every
# shape of the benchmark cells' stacks
_TC_CONFIG = 7
_TC_TILE = (128, 128, 32)
_TC_MIN_CHUNKS = 4
_TC_BLOCK_CHUNKS = 4
_TC_SPLIT_CHUNKS = 0.75
# a stack whose first layer is thin (K at most one K step of the
# tensor-core tile) keeps the register tile while its other layers hold
# fewer multiply-adds than this, over all members (see plan_fwd_stack)
_TC_THIN_STACK_MACS = 25_000_000
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
# the backward's whole-stack kernel (dense_stack_bwd.cu whole_bwd_kernel):
# narrow densenet stacks (U < _RT_MIN) at any M in one launch; the rows of
# a sweep block and the row tiles it has (16 only at U <= 64: a thread
# keeps rows x U/8 of gz in registers), and its shared-memory layout: the
# sweep's ring of _WHOLE_STAGES stages of _WHOLE_CHUNK W rows (U rounded
# up to 64 or 128, plus 4), a reduction task's ring of
# _WHOLE_BWD_TASK_STAGES stages of _WHOLE_BWD_TASK_M batch rows of a
# _WHOLE_BWD_TASK_K-row stream tile and of gz
_WHOLE_BWD_ROWS = 4
_WHOLE_BWD_ROW_TILES = (4, 8, 16)
_WHOLE_BWD_TASK_K = 32
_WHOLE_BWD_TASK_M = 32
_WHOLE_BWD_TASK_STAGES = 4
# ... and its counters, a 128-byte line apart (whole::counters_of)
_WHOLE_BWD_LINE = 32
# forward kernels by the name their launch counts go under
FWD_KERNELS = ("stream", "rt", "tile", "whole", "tc")
# backward kernels by the name their launch counts go under: the per-layer
# kernels (one count a stack backward) and the whole-stack kernel
BWD_KERNELS = ("layers", "whole")

_count_lock = threading.Lock()
_launches = dict.fromkeys(FWD_KERNELS, 0)
_transposes = 0
_bwd_launches = dict.fromkeys(BWD_KERNELS, 0)


def launch_count(kernel: Optional[str] = None) -> int:
    """Forward kernel launches since the last ``reset_launch_count``: of
    every forward kernel (one per layer of every stack forward that ran on
    the card, or one per stack on the whole-stack kernel), or of one of
    ``FWD_KERNELS``: ``"stream"`` (the weight-streaming kernel, M <= 32),
    ``"rt"`` (the register tile), ``"tile"`` (``dense_tile.cuh``),
    ``"whole"`` (the whole narrow densenet stack in one launch) or ``"tc"``
    (the tensor-core tile)."""
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
    if config == _TC_CONFIG:
        return "tc"
    return "rt" if config in _RT_CONFIGS else "tile"


def transpose_count() -> int:
    """``dense_fwd_stream_init`` launches since the last
    ``reset_launch_count``: one per stack forward on the register tile (x
    into the stream and into ``stream^T``)."""
    return _transposes


def bwd_launch_count(kernel: Optional[str] = None) -> int:
    """Backward calls on the card since the last ``reset_launch_count``:
    of every stack backward, or of one of ``BWD_KERNELS``: ``"layers"``
    (a stack backward that launched the per-layer kernels of
    ``dense_stack_bwd.cu`` for every layer it reaches) or ``"whole"`` (one
    launch of the whole-stack kernel)."""
    if kernel is None:
        return sum(_bwd_launches.values())
    return _bwd_launches[kernel]


def reset_launch_count() -> None:
    global _transposes
    with _count_lock:
        _launches.update(dict.fromkeys(FWD_KERNELS, 0))
        _bwd_launches.update(dict.fromkeys(BWD_KERNELS, 0))
        _transposes = 0


def _count_launch(kind: str) -> None:
    """One launch of a forward kernel (``FWD_KERNELS``), of
    ``"transpose"``, or of a backward (``"bwd_layers"``, ``"bwd_whole"``)."""
    global _transposes
    with _count_lock:
        if kind.startswith("bwd_"):
            _bwd_launches[kind[4:]] += 1
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

    def f(x, *params):
        return _concat_loop(x, params[:n], params[n:], connectivity, acts)
    # torch.func.vjp, not torch.autograd.grad: it also runs inside the
    # custom ops' vmap rules, where autograd is dispatched below
    _, vjp = torch.func.vjp(f, *(t.detach() for t in (x, *ws, *bs)))
    grads = vjp(g)
    return grads[0], list(grads[1:1 + n]), list(grads[1 + n:])


def dense_stack_members_ref(x: torch.Tensor, ws: Sequence[torch.Tensor],
                            bs: Sequence[torch.Tensor], *,
                            connectivity: str = "densenet",
                            activation: str = "swish") -> torch.Tensor:
    """``dense_stack_ref`` of each of E members, stacked: ``x`` (E, M, d0),
    ``ws`` (E, K_i, U), ``bs`` (E, U). The plain twin of
    ``dense_stack_members``, bitwise E solo calls."""
    return torch.stack([
        dense_stack_ref(x[e], [w[e] for w in ws], [b[e] for b in bs],
                        connectivity=connectivity, activation=activation)
        for e in range(x.shape[0])])


def dense_stack_members_grads_ref(x: torch.Tensor,
                                  ws: Sequence[torch.Tensor],
                                  bs: Sequence[torch.Tensor],
                                  g: torch.Tensor, *,
                                  connectivity: str = "densenet",
                                  activation: str = "swish",
                                  zs: Optional[torch.Tensor] = None):
    """``dense_stack_grads_ref`` of each of E members, stacked: ``(dx (E, M,
    d0), [dW_i (E, K_i, U)], [db_i (E, U)])``. The plain twin of
    ``dense_stack_members_grads``, bitwise E solo calls."""
    per = [dense_stack_grads_ref(
        x[e], [w[e] for w in ws], [b[e] for b in bs], g[e],
        connectivity=connectivity, activation=activation,
        zs=None if zs is None else zs[e]) for e in range(x.shape[0])]
    return (torch.stack([p[0] for p in per]),
            [torch.stack([p[1][i] for p in per]) for i in range(len(ws))],
            [torch.stack([p[2][i] for p in per]) for i in range(len(ws))])


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("dense_stack_fwd", [SOURCE],
                       [HEADER, RT_HEADER, TC_HEADER])
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
        lib.dense_fwd_stream_init.argtypes = [p, ll, p, ll, p, ll, ll, i, i,
                                              p]
        lib.dense_stack_fwd_whole.argtypes = [i, i, p, ll, i, p, p, i, i, p,
                                              ll, p, ll, i, i, p]
        lib.dense_layer_fwd_tc.argtypes = [p, ll, i, i, p, ll, p, p, ll, p,
                                           ll, p, ll, p, p, i, i, i, i, i, i,
                                           p]
        # the member entries: the solo arguments, the member count and
        # each operand's member stride (the whole stack's w and b as
        # arrays of one a layer), then the stream
        strides = {"dense_layer_fwd": [ll] * 6, "dense_layer_fwd_rt":
                   [ll] * 6, "dense_layer_fwd_stream": [ll] * 7,
                   "dense_fwd_stream_init": [ll] * 3,
                   "dense_stack_fwd_whole": [ll, p, p, ll, ll],
                   "dense_layer_fwd_tc": [ll] * 6}
        for name, types in strides.items():
            solo, members = getattr(lib, name), getattr(lib, name + "_members")
            members.argtypes = solo.argtypes[:-1] + [i] + types + [p]
            solo.restype = members.restype = ctypes.c_int
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
        lib.dense_bwd_whole.argtypes = [i, i, i, p, p, p, p, ll, p, ll, p,
                                        ll, p, ll, p, p, i, i, i, i, i, p]
        # the member entries: the solo arguments, the member count and each
        # operand's member stride (the whole stack's w, dW and db as arrays
        # of one a layer), then the stream
        strides = {"dense_bwd_act_grad": [ll] * 5, "dense_bwd_db": [ll] * 2,
                   "dense_bwd_act": [ll] * 2,
                   "dense_bwd_transpose": [ll] * 2,
                   "dense_bwd_gemm": [ll] * 4, "dense_bwd_gemm_rt": [ll] * 4,
                   "dense_bwd_whole": [ll] * 5 + [p] * 3}
        for name, types in strides.items():
            solo, members = getattr(lib, name), getattr(lib, name + "_members")
            members.argtypes = solo.argtypes[:-1] + [i] + types + [p]
            solo.restype = members.restype = ctypes.c_int
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
    (``config`` forces one), and so do a wide stack's thin products, whose
    only side under ``_RT_MIN`` is the layer's input width (dW's rows, dx's
    columns: the first layer's where d0 < 128), from ``_RT_THIN_MIN`` wide
    (the presets' 35- to 68-wide OFENet features; the tile masks the
    ragged edge), a thin dx unsplit below ``_RT_THIN_SPLIT_K``. Other
    small products (a narrow mlp or d2rl stack, a narrow densenet stack
    the whole-stack backward does not take or ``_kernel_backward(...,
    whole=False)``, a batch under 128, fig3's 3- or 4-wide first layer,
    where ``dense_tile.cuh`` is the faster, small test shapes) keep the
    forward's ``plan``; the OFENet stacks run whole,
    in one launch of the whole-stack backward kernel, and plan no product
    (``whole_bwd_smem``). The rules follow the card (``launch/bwd_sweep.py``:
    both tiles and every split at the critic's and the actor's products,
    and the thin products of the presets on both paths, H100):

    * dW reduces over only the batch, and its output is large: 128x128
      tiles where they are one wave or more and ``vec`` (the stream takes
      16-byte copies), else 128x64; no split unless the tiles fill less
      than half the SMs (a split writes and rereads the whole output).
    * dx reduces over U = 2048 into a small output, so K is split. Its
      blocks stream W^T from device memory, and a second block on an SM
      added nothing, so the plan counts waves of one block per SM: it
      takes 128x64 tiles and the split that minimises waves x chunks per
      split + splits x ``_RT_SPLIT_CHUNKS``; ties go to fewer splits."""
    thin = min(m, n) < _RT_MIN and k >= _RT_MIN \
        and (m if dx else n) >= _RT_MIN and (n if dx else m) >= _RT_THIN_MIN
    if min(m, n, k) < _RT_MIN and not thin:
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
    if dx and thin and k < _RT_THIN_SPLIT_K:
        max_splits = 1
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


def whole_bwd_smem(d0: int, u: int, n_layers: int,
                   rows: int = _WHOLE_BWD_ROWS) -> Optional[int]:
    """Bytes of dynamic shared memory the backward's whole-stack kernel
    takes for a densenet stack (input width ``d0``, ``n_layers`` layers of
    ``u``) at ``rows`` rows a sweep block, or None where it does not take
    the stack (U of ``_RT_MIN`` or more, more than ``_WHOLE_MAX_LAYERS``
    layers, a row tile it lacks, or more than the 227 KB a block may
    have): the larger of a sweep's (its rows of the gradient stream, rows
    padded to 4 floats; its gz rows; the W ring, ``_WHOLE_STAGES`` stages
    of ``_WHOLE_CHUNK`` rows of U rounded up to 64 or 128, plus 4) and a
    reduction task's (its ring of batch rows of a stream tile and of gz)
    (dense_stack_bwd.cu ``whole::smem_bytes``)."""
    if u >= _RT_MIN or not 1 <= n_layers <= _WHOLE_MAX_LAYERS:
        return None
    uc = 64 if u <= 64 else 128
    if rows not in _WHOLE_BWD_ROW_TILES or rows * uc > 1024:
        return None
    sweep = rows * _pad4(d0 + n_layers * u) + rows * uc \
        + _WHOLE_STAGES * _WHOLE_CHUNK * (uc + 4)
    task = _WHOLE_BWD_TASK_STAGES * _WHOLE_BWD_TASK_M \
        * (_WHOLE_BWD_TASK_K + uc)
    size = 4 * max(sweep, task)
    return size if size <= _SMEM_MAX else None


def whole_bwd_blocks(m: int, d0: int, u: int, n_layers: int,
                     need_dw: Sequence[bool], need_db: Sequence[bool],
                     lowest: int = 0, rows: int = _WHOLE_BWD_ROWS
                     ) -> Tuple[int, int]:
    """``(sweeps, tasks)`` of one whole-stack backward: a sweep block a
    ``rows`` rows of the batch; a reduction task a
    ``_WHOLE_BWD_TASK_K``-row tile of each asked-for dW_i (or one for db_i
    alone), layers ``lowest`` and up, summed over the whole batch."""
    def tiles_of(i):
        if need_dw[i]:
            return -(-(d0 + i * u) // _WHOLE_BWD_TASK_K)
        return int(bool(need_db[i]))
    return -(-m // rows), sum(tiles_of(i) for i in range(lowest, n_layers))


def plan_fwd(m: int, n: int, k: int, num_sms: int,
             transposed: bool = True,
             stack: Optional[Tuple[int, int]] = None, members: int = 1
             ) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, per_split)`` of one forward layer with an
    ``(m, n)`` output and a reduction of length ``k``, for ``members``
    fleet members in one launch; ``stack`` is the layer's densenet stack
    ``(d0, layers)`` where the caller can run it whole:

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
    * at least ``_RT_MIN`` rows and columns, N a multiple of 4 (the TMA
      loads' 16-byte rows), every connectivity: the tensor-core tile
      (``_TC_CONFIG``, ``dense_tile_tc.cuh``: 3xTF32 on wgmma, 128 x 128
      tiles, K in chunks of 32), unless ``plan_fwd_stack`` keeps the
      layer's stack on the register tile. K is split to fill the card
      with the launch's ``members`` x ``tiles`` blocks, one a SM: the
      split minimises waves x (chunks per split + ``_TC_BLOCK_CHUNKS`` +
      ``_TC_SPLIT_CHUNKS`` a split past the first), ties to fewer splits,
      at least ``_TC_MIN_CHUNKS`` chunks a split. At U = 2048, K = 2048:
      4 splits solo (128 blocks; 36.4 us, against 43.5 at 3 and 51.0 at
      5), 3 at 5 members (480 blocks; 140.5 us, against 151.6 at 2 and
      154.2 at 4). The card sweep (``launch/bwd_sweep.py --only fwd``,
      H100, M=256, one layer): it beats the register tile at every layer
      but a thin first one from U = 256 up, solo and at 5 members (U =
      2048, K = 2048: 36.4 against 76.1 us solo, 140.5 against 321.4 at 5
      members; U = 256, K = 256: 17.7 against 20.0), and ties it at U =
      128, K = 128 (14.7 against 14.5); at a thin first layer (K = d0 =
      4) it loses at every width (11.2-12.0 against 6.1-6.4 us solo; at U
      = 2048 and 5 members 22.0 against 9.1): a fixed cost a block
      (prologue, the fixup and the activation in the epilogue).
    * the register tile's 128x64 tiles (``_RT_FWD_CONFIG``) where the
      tensor-core tile does not take the layer (N not a multiple of 4; a
      thin stack, ``plan_fwd_stack``): ``_plan_rt``.
    * otherwise (mlp and d2rl past 32 rows with U or M under
      ``_RT_MIN``, or with ``transposed=False``: the path before the
      register tile took them, ``_kernel_forward(..., mlp_rt=False)``; a
      densenet stack too wide for the whole-stack kernel and narrower
      than ``_RT_MIN``), ``dense_tile.cuh`` as ``plan`` plans it (config
      2)."""
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
    if n % 4 != 0:
        return _plan_rt(m, n, k, num_sms)
    bm, bn, bk = _TC_TILE
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    best = None
    for want in range(1, max(1, chunks // _TC_MIN_CHUNKS) + 1):
        per_split = -(-chunks // want)
        splits = -(-chunks // per_split)
        waves = -(-members * tiles * splits // num_sms)
        cost = waves * (per_split + _TC_BLOCK_CHUNKS
                        + _TC_SPLIT_CHUNKS * (splits - 1))
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), (_TC_CONFIG, tiles, splits, per_split))
    return best[1]


def _plan_rt(m: int, n: int, k: int, num_sms: int
             ) -> Tuple[int, int, int, int]:
    """``plan_fwd``'s plan of one layer on the register tile's 128x64
    tiles (``_RT_FWD_CONFIG``, its input transposed): K split into up to
    ``_BLOCKS_PER_SM`` blocks per SM, each with at least
    ``_RT_FWD_MIN_CHUNKS`` chunks, planned as one solo member. The rules
    follow the card (``launch/bwd_sweep.py``: the actor's and the critic's
    layers at M=256, fig3-width's mlp critic, H100): a second block per SM
    hides the first one's loads (the actor's layer 1: 84.4 us at 4 splits,
    94.0 at 2; fig3's critic layer 1, K=2048: 76.5 us at 4, 85.5 at 2,
    121.0 on ``dense_tile.cuh``), and a short K keeps fewer splits (K=4:
    one zero-padded chunk, unsplit)."""
    bm, bn, bk = _RT_CONFIGS[_RT_FWD_CONFIG]
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    splits = max(1, min(_BLOCKS_PER_SM * num_sms // tiles,
                        chunks // _RT_FWD_MIN_CHUNKS))
    per_split = -(-chunks // splits)
    return _RT_FWD_CONFIG, tiles, -(-chunks // per_split), per_split


def plan_fwd_stack(m: int, u: int, ks: Sequence[int], num_sms: int,
                   transposed: bool = True,
                   stack: Optional[Tuple[int, int]] = None,
                   members: int = 1) -> List[Tuple[int, int, int, int]]:
    """``plan_fwd``'s plans of a stack's layers (reductions ``ks``, ``u``
    features each, ``m`` rows, ``members`` members a launch), with one tile
    for the whole stack: the register tile reads a transposed input that
    an init launch starts and its layers extend, the tensor-core tile a
    row-major one. Where ``plan_fwd`` gives the layers the tensor-core
    tile, the stack keeps the register tile (``_plan_rt``) if its first
    layer is thin (K at most one K step, ``_TC_TILE[2]``) and its other
    layers hold fewer than ``_TC_THIN_STACK_MACS`` multiply-adds over all
    members: the tensor-core tile's thin layer costs ~5 us more than the
    register tile's (11.2 against 6.1 us), more than it saves on so little
    work, though the register tile's init launch (x^T) costs ~3 us too.
    Whole stacks with a 4-wide first layer on the card (``chip_smoke.py``'s
    ``time_tc``, H100, M=256), register against tensor-core tile: mlp U =
    128, 2 layers, 23.9 / 26.0 us solo (other layers 4.2 M multiply-adds),
    25.2 / 26.2 at 5 members (21 M); 3 layers 39.2 / 40.7 (8.4 M); d2rl U =
    128, 2 layers, 24.4 / 32.3; U = 256 29.1 / 28.9 solo (17 M, a tie). Past the threshold the tensor-core
    tile wins: U = 128, 16 layers, 238.6 / 231.5 solo (63 M), 257.5 /
    239.4 at 5 members; U = 256 at 5 members 31.6 / 29.7 (84 M); U = 512
    34.2 / 30.5 solo (67 M)."""
    plans = [plan_fwd(m, u, k, num_sms, transposed=transposed, stack=stack,
                      members=members) for k in ks]
    if plans[0][0] == _TC_CONFIG and ks[0] <= _TC_TILE[2] and \
            m * u * members * sum(ks[1:]) < _TC_THIN_STACK_MACS:
        return [_plan_rt(m, u, k, num_sms) for k in ks]
    return plans


def vec_aligned(*operands: Tuple[int, int]) -> bool:
    """True when every ``(address, row stride in floats)`` operand takes
    16-byte loads: the address a multiple of 16 bytes, the stride of 4
    floats. The register tile copies each operand 16 bytes at a time where
    this holds for it, single floats elsewhere."""
    return all(ptr % 16 == 0 and ld % 4 == 0 for ptr, ld in operands)


def operand(t: torch.Tensor, col: int = 0) -> Tuple[int, int]:
    """``(address, row stride)`` of a float32 tensor from column ``col``
    of its row 0 (of member 0's, for a member-axis tensor): one operand of
    ``vec_aligned``."""
    return t.data_ptr() + 4 * col, t.stride(-2)


def _ms(t: Optional[torch.Tensor], dims: int = 2) -> int:
    """Member stride in floats of a member-axis tensor (the leading axis of
    a tensor with more than ``dims`` axes; 0 when its members share it);
    0 for a solo tensor or None."""
    return 0 if t is None or t.dim() <= dims else t.stride(0)


def _op(t: torch.Tensor, col: int = 0) -> Tuple[int, int, int]:
    """``(address, row stride, member stride)`` from column ``col``."""
    return (*operand(t, col), _ms(t))


def _vec(op: Tuple[int, int, int]) -> bool:
    """``vec_aligned`` of an ``_op`` for every member: its member stride
    a multiple of 4 floats too."""
    return vec_aligned(op[:2]) and op[2] % 4 == 0


def _call(lib, name: str, args, members: Optional[int], strides,
          stream: int) -> int:
    """``lib.<name>(*args, stream)``, or for ``members`` members its member
    entry ``<name>_members(*args, members, *strides, stream)``, one launch
    for all of them; returns the CUDA error."""
    if members is None:
        return getattr(lib, name)(*args, stream)
    return getattr(lib, name + "_members")(*args, members, *strides, stream)


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


def _members(t: torch.Tensor) -> Optional[int]:
    """E of a member-axis output (3-D), None for a solo one (2-D)."""
    return t.shape[0] if t.dim() == 3 else None


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
    the pre-activation when given. The register tile reads its input from
    ``at`` (transposed: ``w``'s rows of it, rows padded to 4 floats)
    instead of the segments and writes its output transposed into ``yt``
    when given; its ``out`` may then be None (mlp and d2rl's layers below
    the last, read only transposed), ``yt``'s columns ``[0, M)`` giving M.
    The streaming kernel also copies ``seg1``'s columns into the first
    columns of ``acopy`` when given (x into densenet's stream). A 3-D
    ``out`` (or ``yt``) is E members' (every tensor then with a leading
    member axis, of stride 0 where the members share it): one member
    launch."""
    config, tiles, splits, per_split = plan
    a1, c1 = seg1 if seg1 is not None else (None, 0)
    rows_of = out if out is not None else yt
    e = _members(rows_of)
    lead = () if e is None else (e,)
    m = out.shape[-2] if out is not None else yt.shape[-1]
    n = w.shape[-1]
    k2 = 0 if seg2 is None else seg2[0].shape[-1] - seg2[1]
    k1 = w.shape[-2] - k2
    kind = fwd_kernel_of(config)
    ws_buf = counters = None
    if splits > 1:
        ws_buf = torch.empty((*lead, splits, m,
                              _pad4(n) if kind != "tile" else n),
                             device=w.device, dtype=torch.float32)
        counters = _tile_counters(tiles * (e or 1), w.device, stream)
    z_ptr, ldz = (None, 0) if z is None else (_ptr(*z), z[0].stride(-2))
    sz = 0 if z is None else _ms(z[0])
    vec_w = int(_vec(_op(w)))
    if kind == "rt":
        err = _call(lib, "dense_layer_fwd_rt", (
            config, vec_w, at.data_ptr(), at.stride(-2), w.data_ptr(),
            w.stride(-2), b.data_ptr(), _ptr(out, col),
            0 if out is None else out.stride(-2), z_ptr, ldz, _ptr(yt),
            0 if yt is None else yt.stride(-2), _ptr(ws_buf),
            _ptr(counters), m, n, k1, act, splits, per_split),
            e, (_ms(at), _ms(w), _ms(b, 1), _ms(out), sz, _ms(yt)), stream)
    else:
        a2_ptr, lda2, sa2 = None, 0, 0
        if seg2 is not None:
            a2_ptr, lda2, sa2 = _ptr(*seg2), seg2[0].stride(-2), \
                _ms(seg2[0])
        if kind == "stream":
            err = _call(lib, "dense_layer_fwd_stream", (
                vec_w, _ptr(a1, c1), a1.stride(-2), k1, a2_ptr, lda2, k2,
                w.data_ptr(), w.stride(-2), b.data_ptr(), _ptr(out, col),
                out.stride(-2), z_ptr, ldz, _ptr(acopy),
                0 if acopy is None else acopy.stride(-2), _ptr(ws_buf),
                _ptr(counters), m, n, act, splits, per_split), e,
                (_ms(a1), sa2, _ms(w), _ms(b, 1), _ms(out), sz,
                 _ms(acopy)), stream)
        else:
            err = _call(lib, "dense_layer_fwd", (
                config, _ptr(a1, c1), a1.stride(-2), k1, a2_ptr, lda2, k2,
                w.data_ptr(), b.data_ptr(), _ptr(out, col), out.stride(-2),
                z_ptr, ldz, _ptr(ws_buf), _ptr(counters), m, n, act, splits,
                per_split), e,
                (_ms(a1), sa2, _ms(w), _ms(b, 1), _ms(out), sz), stream)
    if err != 0:
        raise RuntimeError(f"dense_stack forward ({kind}) launch failed: "
                           f"CUDA error {err} (m={m}, n={n}, k={k1 + k2}, "
                           f"config={config}, splits={splits}, members={e})")
    _count_launch(kind)


def _launch_whole(lib, x: torch.Tensor, ws, bs, out: torch.Tensor,
                  zs: Optional[torch.Tensor], act: int, rows: int,
                  stream: int) -> None:
    """A whole densenet stack in one launch of the whole-stack kernel at
    ``rows`` rows a block: x into ``out``'s first columns, y_i into its
    slots, z_i into ``zs``'s when given (E members' at once for a 3-D
    ``out``)."""
    (m, d0), n_layers, u = x.shape[-2:], len(ws), ws[0].shape[-1]
    e = _members(out)
    vec_w = int(all(_vec(_op(w)) for w in ws))

    def arr(values):
        return (ctypes.c_longlong * n_layers)(*values)
    err = _call(lib, "dense_stack_fwd_whole", (
        rows, vec_w, x.data_ptr(), x.stride(-2), n_layers,
        arr(w.data_ptr() for w in ws), arr(b.data_ptr() for b in bs), d0, u,
        out.data_ptr(), out.stride(-2), _ptr(zs),
        0 if zs is None else zs.stride(-2), m, act), e,
        (_ms(x), arr(_ms(w) for w in ws), arr(_ms(b, 1) for b in bs),
         _ms(out), _ms(zs)), stream)
    if err != 0:
        raise RuntimeError(f"dense_stack forward (whole) launch failed: CUDA "
                           f"error {err} (m={m}, d0={d0}, u={u}, layers="
                           f"{n_layers}, rows={rows}, members={e})")
    _count_launch("whole")


def _launch_tc(lib, plan, a: torch.Tensor, k_off: int, w: torch.Tensor,
               b: torch.Tensor, y: Optional[Tuple[torch.Tensor, int]],
               z: Optional[Tuple[torch.Tensor, int]],
               y2: Optional[Tuple[torch.Tensor, int]], act: int,
               stream: int) -> None:
    """One layer on the tensor-core tile (``plan``: ``plan_fwd``'s): z =
    ``a[:, k_off:k_off + K] @ w + b`` (K = ``w``'s rows), act(z) into ``y``
    and ``y2``, z into ``z``, each ``(tensor, first column)`` or None. The
    kernel reads ``a`` and ``w`` through TMA: rows 16-byte aligned (``a``
    is the wrapper's own padded buffer; a ``w`` that is not gets an
    aligned copy). A 3-D ``a`` is E members' (every tensor then with a
    leading member axis, ``w`` and ``b`` of stride 0 where the members
    share them): one member launch."""
    config, tiles, splits, per_split = plan
    e = _members(a)
    lead = () if e is None else (e,)
    m, n, k = a.shape[-2], w.shape[-1], w.shape[-2]
    # check: disable=R003 -- reads the address and strides, not values
    if not (_vec(_op(w)) and w.stride(-1) == 1):
        w = w.clone(memory_format=torch.contiguous_format)
    ws_buf = counters = None
    if splits > 1:
        bm, bn, _ = _TC_TILE
        ws_buf = torch.empty((*lead, splits * tiles * bm * bn),
                             device=w.device, dtype=torch.float32)
        counters = _tile_counters(tiles * (e or 1), w.device, stream)

    def dst(t):
        return (None, 0, 0) if t is None else \
            (_ptr(*t), t[0].stride(-2), _ms(t[0]))
    (y_ptr, ldy, sy), (z_ptr, ldz, sz), (y2_ptr, ldy2, sy2) = \
        dst(y), dst(z), dst(y2)
    err = _call(lib, "dense_layer_fwd_tc", (
        a.data_ptr(), a.stride(-2), k_off + k, k_off, w.data_ptr(),
        w.stride(-2), b.data_ptr(), y_ptr, ldy, z_ptr, ldz, y2_ptr, ldy2,
        _ptr(ws_buf), _ptr(counters), m, n, k, act, splits, per_split), e,
        (_ms(a), _ms(w), _ms(b, 1), sy, sz, sy2), stream)
    if err != 0:
        raise RuntimeError(f"dense_stack forward (tc) launch failed: CUDA "
                           f"error {err} (m={m}, n={n}, k={k}, k_off={k_off}"
                           f", splits={splits}, members={e})")
    _count_launch("tc")


def _dense(t: torch.Tensor, dims: int) -> bool:
    """Whether ``t`` is dense the way the kernels read it: contiguous, or,
    with a leading member axis, contiguous within each member (any member
    stride, 0 included)."""
    if t.dim() == dims:
        return t.is_contiguous()
    return t.shape[0] == 0 or t[0].is_contiguous()


def _check_cuda(x: torch.Tensor, ws, bs, connectivity: str) -> None:
    d0, u = x.shape[-1], ws[0].shape[-1]
    lead = tuple(x.shape[:-2])
    for name, t, dims in [("x", x, 2)] + \
            [(f"ws[{i}]", w, 2) for i, w in enumerate(ws)] + \
            [(f"bs[{i}]", b, 1) for i, b in enumerate(bs)]:
        if t.device != x.device:
            raise ValueError(f"dense_stack: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"dense_stack kernel takes float32; {name} is "
                            f"{t.dtype}")
        if tuple(t.shape[:-dims]) != lead:
            raise ValueError(f"dense_stack: {name} {tuple(t.shape)} has "
                             f"not x's member axis {lead}")
        if not _dense(t, dims):
            raise ValueError(f"dense_stack kernel needs contiguous tensors; "
                             f"{name} is not")
    for i, (w, b) in enumerate(zip(ws, bs)):
        want = (in_dim(connectivity, i, d0, u), u)
        if tuple(w.shape[-2:]) != want or tuple(b.shape[-1:]) != (u,):
            raise ValueError(f"dense_stack layer {i}: w {tuple(w.shape)}, "
                             f"b {tuple(b.shape)}; want w {want}, b ({u},)")


def _stream_init(lib, x: torch.Tensor, dst: Optional[torch.Tensor],
                 dst_t: torch.Tensor, dup: int, stream: int) -> None:
    """x^T into ``dst_t`` (rows of 4-float-padded stride) before the
    register tile's first layer, and x into ``dst`` (densenet's stream)
    when given, or a second x^T ``dup`` floats past ``dst_t`` (d2rl's
    other ping-pong buffer) when ``dup`` > 0: one launch."""
    e = _members(x)
    m, d0 = x.shape[-2:]
    err = _call(lib, "dense_fwd_stream_init", (
        x.data_ptr(), x.stride(-2), _ptr(dst),
        0 if dst is None else dst.stride(-2), dst_t.data_ptr(),
        dst_t.stride(-2), dup, m, d0), e,
        (_ms(x), _ms(dst), _ms(dst_t)), stream)
    if err != 0:
        raise RuntimeError(f"dense_fwd_stream_init launch failed: CUDA "
                           f"error {err} (m={m}, d0={d0}, dup={dup}, "
                           f"members={e})")
    _count_launch("transpose")


def _kernel_forward(x: torch.Tensor, ws, bs, connectivity: str,
                    activation: str, zs: Optional[torch.Tensor] = None,
                    whole: bool = True, mlp_rt: bool = True) -> torch.Tensor:
    """The stack's feature; with ``zs`` (``(M, L*U)``), layer i also stores
    its pre-activation into columns ``[i*U, (i+1)*U)``. ``whole=False``
    keeps a narrow densenet stack on the per-layer kernels (what the card
    sweep compares the whole-stack kernel with); ``mlp_rt=False`` keeps
    mlp and d2rl past 32 rows on ``dense_tile.cuh`` (what the card's timing
    compares their register tile with). With a leading member axis (``x``
    (E, M, d0), ``ws`` (E, K_i, U), ``bs`` (E, U), ``zs`` (E, M, L*U)) E
    members run in one launch per solo launch, planned for E members
    (``plan_fwd_stack``'s ``members``)."""
    _check_cuda(x, ws, bs, connectivity)
    e = x.shape[0] if x.dim() == 3 else None
    m, d0 = x.shape[-2:]
    if m == 0 or e == 0:
        return _forward_planned(x, ws, bs, connectivity, activation, zs, [])
    dense = connectivity == "densenet"
    plans = plan_fwd_stack(
        m, ws[0].shape[-1], [w.shape[-2] for w in ws],
        _device_info(x.device)[0],
        transposed=dense or mlp_rt,
        stack=(d0, len(ws)) if dense and whole else None, members=e or 1)
    return _forward_planned(x, ws, bs, connectivity, activation, zs, plans)


def _forward_planned(x: torch.Tensor, ws, bs, connectivity: str,
                     activation: str, zs: Optional[torch.Tensor], plans
                     ) -> torch.Tensor:
    """``_kernel_forward`` by the given layer ``plans`` (the stack's one
    tile in each: ``plan_fwd_stack``'s, or for timing another tile's, as
    ``_plan_rt`` plans the register tile)."""
    lead = tuple(x.shape[:-2])
    m, d0 = x.shape[-2:]
    n_layers, u = len(ws), ws[0].shape[-1]
    dev = x.device
    out_w = feature_dim(connectivity, n_layers, d0, u)
    if m == 0 or 0 in lead:
        return torch.empty((*lead, m, out_w), device=dev,
                           dtype=torch.float32)
    lib = _library()
    act = _ACT_CODE[activation]
    kind = plans[0][0]                  # every layer alike: one tile
    with torch.cuda.device(dev):
        stream = _device_info(dev)[1]

        def z_slot(i):
            return None if zs is None else (zs, i * u)
        if kind == _TC_CONFIG:
            return _tc_stack(lib, x, ws, bs, connectivity, plans, zs, act,
                             stream)
        if connectivity == "densenet":
            out = torch.empty((*lead, m, out_w), device=dev,
                              dtype=torch.float32)
            if kind == _WHOLE_CONFIG:
                _launch_whole(lib, x, ws, bs, out, zs, act, plans[0][3],
                              stream)
                return out
            st = None                   # stream^T: x^T, y_0^T .. y_{L-2}^T
            if kind in _RT_CONFIGS:
                st = torch.empty((*lead, d0 + (n_layers - 1) * u, _pad4(m)),
                                 device=dev, dtype=torch.float32)
                _stream_init(lib, x, out, st, 0, stream)
            elif kind != _STREAM_CONFIG:
                out[..., :d0].copy_(x)
            for i in range(n_layers):
                d = d0 + i * u
                yt = st[..., d:d + u, :] \
                    if st is not None and i < n_layers - 1 else None
                # the streaming kernel's layer 0 reads x and copies it in
                first = i == 0 and kind == _STREAM_CONFIG
                _launch_layer(lib, plans[i], (x, 0) if first else (out, 0),
                              None, ws[i], bs[i], out, d, act, stream,
                              z_slot(i), st, yt, out if first else None)
            return out
        if kind in _RT_CONFIGS:
            return _rt_hidden(lib, x, ws, bs, connectivity, plans, zs, act,
                              stream)
        bufs = [torch.empty((*lead, m, u), device=dev, dtype=torch.float32)
                for _ in range(min(n_layers, 2))]
        h = x
        for i in range(n_layers):
            dst = bufs[i % 2]
            seg2 = (x, 0) if connectivity == "d2rl" and i > 0 else None
            _launch_layer(lib, plans[i], (h, 0), seg2, ws[i], bs[i], dst, 0,
                          act, stream, z_slot(i))
            h = dst
        return h


def _rt_hidden(lib, x: torch.Tensor, ws, bs, connectivity: str, plans,
               zs: Optional[torch.Tensor], act: int, stream: int
               ) -> torch.Tensor:
    """An mlp or d2rl stack on the register tile, which reads its input
    transposed (along K): one init writes x^T, each layer below the last
    writes only its output transposed (y_i^T), where the next layer reads
    it, and the last layer writes the row-major feature; every layer
    writes z_i into ``zs`` when given.

    One buffer of rows padded to 4 floats holds two ping-pong slots. mlp:
    ``[x^T | h_a^T | h_b^T]`` (d0 + 2U rows); layer 0 reads x^T, layer i
    reads the slot layer i-1 wrote. d2rl: two slabs ``[h^T | x^T]`` of U +
    d0 rows, x^T written into both by the one init (``dup``), so that the
    input ``[h | x]`` of every layer past the first is one operand of
    consecutive rows in the weight's row order; layer 0 reads slab 0's
    x^T, layer i slab ``i % 2`` whole, and writes h_i^T into the other."""
    lead = tuple(x.shape[:-2])
    m, d0 = x.shape[-2:]
    n_layers, u = len(ws), ws[0].shape[-1]
    mp = _pad4(m)
    d2rl = connectivity == "d2rl"
    slab = u + d0 if d2rl else u
    rows = 2 * slab if d2rl else d0 + min(2, n_layers - 1) * u
    buf = torch.empty((*lead, rows, mp), device=x.device,
                      dtype=torch.float32)[..., :m]
    if d2rl:
        _stream_init(lib, x, None, buf[..., u:slab, :], slab * mp, stream)
    else:
        _stream_init(lib, x, None, buf[..., :d0, :], 0, stream)

    def read(i):                        # layer i's input, transposed
        if d2rl:
            return buf[..., u:slab, :] if i == 0 else \
                buf[..., (i % 2) * slab:(i % 2 + 1) * slab, :]
        if i == 0:
            return buf[..., :d0, :]
        at = d0 + ((i - 1) % 2) * u
        return buf[..., at:at + u, :]

    def written(i):                     # where layer i's h_i^T goes
        at = (1 - i % 2) * slab if d2rl else d0 + (i % 2) * u
        return buf[..., at:at + u, :]
    out = torch.empty((*lead, m, u), device=x.device, dtype=torch.float32)
    for i in range(n_layers):
        last = i == n_layers - 1
        _launch_layer(lib, plans[i], None, None, ws[i], bs[i],
                      out if last else None, 0, act, stream,
                      None if zs is None else (zs, i * u), read(i),
                      None if last else written(i))
    return out


def _tc_stack(lib, x: torch.Tensor, ws, bs, connectivity: str, plans,
              zs: Optional[torch.Tensor], act: int, stream: int
              ) -> torch.Tensor:
    """A stack on the tensor-core tile, which reads every layer's input
    row-major through TMA, from rows padded to 4 floats: every layer
    writes z_i into ``zs`` when given.

    densenet: a padded copy of the stream below the last layer, ``[x | y_0
    | .. | y_{L-2}]``; layer i reads its first d0 + i U columns and writes
    y_i into its slot there (i < L - 1) and into the returned stream
    ``out``'s (whose rows, d0 + L U floats, the actor's 4355, TMA cannot
    read). mlp: layer 0 reads x (a padded copy where its rows are not
    16-byte aligned, the pendulum's 3-wide observation, or its members
    share it), layer i > 0 the ping-pong buffer layer i - 1 wrote. d2rl:
    two slabs ``[h | x]`` of U + d0 columns, x copied into both, so the
    input ``[h_{i-1} | x]`` of every layer past the first is one operand;
    layer 0 reads slab 0's x columns (``k_off`` = U), layer i slab (i - 1)
    % 2 whole, and writes h_i into slab i % 2's first U columns. The last
    layer of mlp and d2rl writes only the row-major feature."""
    lead = tuple(x.shape[:-2])
    m, d0 = x.shape[-2:]
    n_layers, u = len(ws), ws[0].shape[-1]

    def padded(width):
        return torch.empty((*lead, m, _pad4(width)), device=x.device,
                           dtype=torch.float32)[..., :width]

    def z_slot(i):
        return None if zs is None else (zs, i * u)
    if connectivity == "densenet":
        sp = padded(d0 + (n_layers - 1) * u)
        out = torch.empty((*lead, m, d0 + n_layers * u), device=x.device,
                          dtype=torch.float32)
        out[..., :d0].copy_(x)
        sp[..., :d0].copy_(x)
        for i in range(n_layers):
            slot = d0 + i * u
            _launch_tc(lib, plans[i], sp, 0, ws[i], bs[i], (out, slot),
                       z_slot(i), (sp, slot) if i < n_layers - 1 else None,
                       act, stream)
        return out
    out = torch.empty((*lead, m, u), device=x.device, dtype=torch.float32)
    if connectivity == "d2rl":
        slabs = [padded(u + d0) for _ in range(min(2, n_layers))]
        for slab in slabs:
            slab[..., u:].copy_(x)
        reads = [(slabs[0], u)] + [(slabs[(i - 1) % 2], 0)
                                   for i in range(1, n_layers)]
        writes = [slabs[i % 2] for i in range(n_layers)]
    else:
        xa = x
        if not _vec(_op(x)) or (lead and _ms(x) == 0):
            xa = padded(d0)
            xa.copy_(x)
        hs = [padded(u) for _ in range(min(2, n_layers - 1))]
        reads = [(xa, 0)] + [(hs[(i - 1) % 2], 0)
                             for i in range(1, n_layers)]
        writes = [hs[i % 2] if i < n_layers - 1 else None
                  for i in range(n_layers)]
    for i in range(n_layers):
        dst = out if i == n_layers - 1 else writes[i]
        _launch_tc(lib, plans[i], *reads[i], ws[i], bs[i], (dst, 0),
                   z_slot(i), None, act, stream)
    return out


def _pad4(n: int) -> int:
    """n rounded up to a multiple of 4 (a 16-byte row of float32)."""
    return n + -n % 4


class _Backward:
    """One stack backward on the card: the launches of
    ``dense_stack_bwd.cu`` (see its header), layer by layer in reverse;
    with ``members``, E members' in one launch each (every tensor then with
    a leading member axis)."""

    def __init__(self, m: int, u: int, activation: str, dev: torch.device,
                 members: Optional[int] = None):
        self.lib = _bwd_library()
        self.m, self.u, self.dev = m, u, dev
        self.e = members
        self.lead = () if members is None else (members,)
        self.act = _ACT_CODE[activation]
        self.num_sms, self.stream = _device_info(dev)

    def _empty(self, *shape) -> torch.Tensor:
        return torch.empty((*self.lead, *shape), device=self.dev,
                           dtype=torch.float32)

    def _counters(self, n: int) -> torch.Tensor:
        return _tile_counters(n * (self.e or 1), self.dev, self.stream)

    def _launch(self, name: str, args, strides, what: str = "") -> None:
        err = _call(self.lib, name, args, self.e, strides, self.stream)
        if err != 0:
            raise RuntimeError(f"{name} {what}launch failed: CUDA error "
                               f"{err} (members={self.e})")

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
        gzt = self._empty(self.u, _pad4(self.m))[..., :self.m] \
            if transpose else None
        part = self._empty(_ACT_ROW_BLOCKS, self.u) if need_db else None
        self._launch("dense_bwd_act_grad", (
            _ptr(g, gcol), g.stride(-2), _ptr(zs, i * self.u), zs.stride(-2),
            gz.data_ptr(), _ptr(gzt), 0 if gzt is None else gzt.stride(-2),
            _ptr(part), self.m, self.u, self.act),
            (_ms(g), _ms(zs), _ms(gz), _ms(gzt), _ms(part)))
        return gz, gzt, part

    def db(self, part: torch.Tensor, db: torch.Tensor) -> None:
        """``db`` = the rows of ``act_grad``'s sums added in order."""
        self._launch("dense_bwd_db", (part.data_ptr(), db.data_ptr(),
                                      self.u), (_ms(part), _ms(db, 1)))

    def act_of(self, zs: torch.Tensor, i: int) -> torch.Tensor:
        """``act(z_i)``: layer i's output, for mlp/d2rl."""
        h = self._empty(self.m, self.u)
        self._launch("dense_bwd_act", (
            _ptr(zs, i * self.u), zs.stride(-2), h.data_ptr(), self.m,
            self.u, self.act), (_ms(zs), _ms(h)))
        return h

    def transpose(self, t: torch.Tensor) -> torch.Tensor:
        """``t^T`` of a 2-D float32 view with unit column stride (of each
        member's), rows padded to 4 floats."""
        rows, cols = t.shape[-2:]
        out = self._empty(cols, _pad4(rows))[..., :rows]
        self._launch("dense_bwd_transpose", (
            t.data_ptr(), t.stride(-2), out.data_ptr(), out.stride(-2), rows,
            cols), (_ms(t), _ms(out)))
        return out

    def _product(self, plan, dx: bool, a_op, b_op, out: torch.Tensor,
                 ocol: int, orow: int, m: int, n: int, k: int,
                 accumulate: bool, add=None) -> None:
        """``out[orow:, ocol:]`` (m, n) (+)= a product over k, or = ``add`` +
        the product (register tile only). Register tile: ``a^T @ b`` with a
        (k, m) and b (k, n); dense_tile.cuh: dW as ``a^T @ b`` likewise, dx
        as ``a @ b^T`` with a (m, k) and b (n, k). Operands, ``add`` too,
        are ``_op``s: ``(address, row stride, member stride)``."""
        config, tiles, splits, per_split = plan
        rt = config in _RT_CONFIGS
        ws_buf = counters = None
        if splits > 1:
            ws_buf = self._empty(splits, m, _pad4(n) if rt else n)
            counters = self._counters(tiles)
        ldo, so = out.stride(-2), _ms(out)
        out_ptr = _ptr(out, orow * ldo + ocol)
        what = f"(config {config}, m={m}, n={n}, k={k}, splits={splits}) "
        if rt:
            vec = int(_vec(a_op)) | 2 * int(_vec(b_op))
            if add is None:
                add = (out_ptr, ldo, so) if accumulate else (None, 0, 0)
            self._launch("dense_bwd_gemm_rt", (
                config, int(dx), vec, *a_op[:2], *b_op[:2], out_ptr, ldo,
                *add[:2], _ptr(ws_buf), _ptr(counters), m, n, k, splits,
                per_split), (a_op[2], b_op[2], so, add[2]), what)
        else:
            if add is not None:
                raise ValueError("dense_tile.cuh adds in place only")
            self._launch("dense_bwd_gemm", (
                config, int(not dx), int(dx), *a_op[:2], k, None, 0, 0,
                *b_op[:2], out_ptr, ldo, int(accumulate), _ptr(ws_buf),
                _ptr(counters), m, n, splits, per_split),
                (a_op[2], 0, b_op[2], so), what)

    def dw(self, inp: torch.Tensor, col: int, k: int, gz: torch.Tensor,
           dw: torch.Tensor, row: int, config: Optional[int] = None) -> None:
        """``dw[row:row+k] = inp[:, col:col+k]^T @ gz`` (reduces the batch)."""
        a_op = _op(inp, col)
        plan = plan_bwd(k, self.u, self.m, self.num_sms, config,
                        vec=_vec(a_op))
        self._product(plan, False, a_op, _op(gz), dw, 0, row, k, self.u,
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
        a, b = gz, w[..., row:row + k, :]
        if plan[0] in _RT_CONFIGS:
            a, b = gzt, self.transpose(b) if wt is None else wt
        self._product(plan, True, _op(a), _op(b), out, col, 0, self.m, k,
                      self.u, accumulate, add)


def _launch_whole_bwd(out: torch.Tensor, zs: torch.Tensor, ws,
                      g: torch.Tensor, act: int, need_dx: bool, need_dw,
                      need_db, lowest: int, rows: int = _WHOLE_BWD_ROWS):
    """``(dx, dws, dbs)`` of a narrow densenet stack from the forward's
    output ``out`` and ``zs`` in ONE launch of the whole-stack backward
    kernel at ``rows`` rows a sweep block; E members' at once for a 3-D
    ``zs``; None where not asked for."""
    n_layers, u = len(ws), ws[0].shape[-1]
    d0 = ws[0].shape[-2]
    m = zs.shape[-2]
    e = _members(zs)
    lead = () if e is None else (e,)
    dev = zs.device
    uc = 64 if u <= 64 else 128

    def empty(*shape):
        return torch.empty((*lead, *shape), device=dev, dtype=torch.float32)
    dws = [empty(d0 + i * u, u) if need_dw[i] else None
           for i in range(n_layers)]
    dbs = [empty(u) if need_db[i] else None for i in range(n_layers)]
    dx = empty(m, d0) if need_dx else None
    gz = empty(n_layers, m, uc) if any(need_dw) or any(need_db) else None
    _, stream = _device_info(dev)
    counters = _tile_counters(_WHOLE_BWD_LINE * (n_layers + 1) * (e or 1),
                              dev, stream)
    vec_w = int(u % 4 == 0 and all(_vec(_op(w)) for w in ws))

    def arr(values):
        return (ctypes.c_longlong * n_layers)(*values)
    err = _call(_bwd_library(), "dense_bwd_whole", (
        rows, vec_w, n_layers, arr(w.data_ptr() for w in ws),
        arr(0 if t is None else t.data_ptr() for t in dws),
        arr(0 if t is None else t.data_ptr() for t in dbs),
        out.data_ptr(), out.stride(-2), zs.data_ptr(), zs.stride(-2),
        g.data_ptr(), g.stride(-2), _ptr(dx), 0 if dx is None else d0,
        _ptr(gz), counters.data_ptr(), m, d0, u, lowest, act), e,
        (_ms(out), _ms(zs), _ms(g), _ms(dx), _ms(gz, 3),
         arr(_ms(w) for w in ws), arr(_ms(t) for t in dws),
         arr(_ms(t, 1) for t in dbs)), stream)
    if err != 0:
        raise RuntimeError(f"dense_stack backward (whole) launch failed: "
                           f"CUDA error {err} (m={m}, d0={d0}, u={u}, "
                           f"layers={n_layers}, rows={rows}, members={e})")
    _count_launch("bwd_whole")
    return dx, dws, dbs


def _kernel_backward(saved, ws, g: torch.Tensor, connectivity: str,
                     activation: str, need_dx: bool, need_dw, need_db,
                     whole: bool = True):
    """``(dx, dws, dbs)`` on the card, None where not asked for. ``saved``
    is the forward's output stream (densenet) or its input ``x`` (mlp,
    d2rl), then the pre-activations ``zs``. With a leading member axis on
    ``zs`` (E, M, L*U) (and on the rest: ``ws`` (E, K_i, U), ``g``), E
    members' in one launch per solo launch, their gradients with it.

    A narrow densenet stack whose shared memory fits (``whole_bwd_smem``:
    the OFENet stacks) runs whole, in ONE launch of the whole-stack
    backward kernel; ``whole=False`` keeps it on the per-layer kernels
    below (what the card's timing compares it with).

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
    n_layers, u = len(ws), ws[0].shape[-1]
    d0 = ws[0].shape[-2]
    m = zs.shape[-2]
    e = _members(zs)
    lead = () if e is None else (e,)
    dws: list = [None] * n_layers
    dbs: list = [None] * n_layers
    wanted = [i for i in range(n_layers) if need_dw[i] or need_db[i]]
    lowest = 0 if need_dx else (min(wanted) if wanted else n_layers)
    if lowest == n_layers or m == 0 or e == 0:
        return None, dws, dbs
    if g.dtype != torch.float32:
        raise TypeError(f"dense_stack backward takes a float32 gradient, "
                        f"got {g.dtype}")
    dev = g.device
    with torch.cuda.device(dev):
        # check: disable=R003 -- _dense reads strides, not values
        if not _dense(g, 2):
            g = g.contiguous()
        if whole and connectivity == "densenet" and \
                whole_bwd_smem(d0, u, n_layers) is not None:
            return _launch_whole_bwd(stream_or_x, zs, ws, g,
                                     _ACT_CODE[activation], need_dx,
                                     need_dw, need_db, lowest)
        main = torch.cuda.current_stream(dev)
        side = _side_stream(dev, main)
        bw = _Backward(m, u, activation, dev, e)
        bws = bw.on(side)

        def off_chain(i, gz, part, segments):
            """db_i and dW_i on the side stream, once the caller's stream
            has made gz and the row sums: dW's rows from each ``(input,
            first row)`` segment."""
            dbs[i] = bw._empty(u) if part is not None else None
            if segments:
                dws[i] = bw._empty(ws[i].shape[-2], u)
            side.wait_stream(main)
            for t in (gz, part, dbs[i], dws[i], *(t for t, _ in segments)):
                if t is not None:
                    t.record_stream(side)
            with torch.cuda.stream(side):
                if part is not None:
                    bws.db(part, dbs[i])
                for inp, row in segments:
                    bws.dw(inp, 0, inp.shape[-1], gz, dws[i], row)

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
            width = k_top if from_g else g.shape[-1]
            gb = torch.empty((*lead, m, _pad4(width)), device=dev,
                             dtype=torch.float32)[..., :width]
            if not from_g:
                gb.copy_(g)
            dx = torch.empty((*lead, m, d0), device=dev) \
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
                          [(stream_or_x[..., :k], 0)] if need_dw[i] else [])
                if g_in:
                    if i in wts:
                        main.wait_event(ready[i])
                    out = dx if i == 0 and dx is not None else gb
                    bw.dinput(gz, gzt, ws[i], 0, k, out, 0, accumulate=True,
                              wt=wts.pop(i, None),
                              add=None if src is out else _op(src))
            if need_dx and dx is None:
                dx = gb[..., :d0].contiguous()
        else:
            x = stream_or_x
            d2rl = connectivity == "d2rl"
            gh = g
            gx = torch.zeros((*lead, m, d0), device=dev) \
                if need_dx and d2rl else None
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
    _count_launch("bwd_layers")
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


# ---------------------------------------------------------------------------
# E members at once: a fleet's member axis (under torch.func.vmap)
# ---------------------------------------------------------------------------

def _stacked(t: torch.Tensor, dims: int) -> torch.Tensor:
    """``t`` (E, ...) as the member kernels read it: itself where each
    member is contiguous (any member stride, 0 for a shared operand),
    else a contiguous copy."""
    # check: disable=R003 -- _dense reads strides, not values
    return t if _dense(t, dims) else t.contiguous()


def dense_stack_members(x: torch.Tensor, ws: Sequence[torch.Tensor],
                        bs: Sequence[torch.Tensor], *,
                        connectivity: str = "densenet",
                        activation: str = "swish",
                        zs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The feature of E members' stacks, ``(E, M, F)``: ``x`` (E, M, d0),
    ``ws`` (E, K_i, U), ``bs`` (E, U), each of member stride 0 where the
    members share it (``expand``). On a CUDA tensor every kernel launches
    once for all members, planned for E members, so member e is bitwise
    its solo launches of the same plan; with ``zs`` (E, M, L*U) the
    pre-activations go there too. On a CPU tensor the members twin,
    ``dense_stack_members_ref`` (``zs`` not written)."""
    _validate(connectivity, activation, ws, bs)
    if x.dim() != 3:
        raise ValueError(f"dense_stack_members: x {tuple(x.shape)}, want "
                         f"(E, M, d0)")
    if x.device.type == "cpu":
        return dense_stack_members_ref(x, ws, bs, connectivity=connectivity,
                                       activation=activation)
    return _kernel_forward(_stacked(x, 2), [_stacked(w, 2) for w in ws],
                           [_stacked(b, 1) for b in bs], connectivity,
                           activation, zs)


def dense_stack_members_grads(x: torch.Tensor, ws: Sequence[torch.Tensor],
                              bs: Sequence[torch.Tensor], g: torch.Tensor,
                              *, connectivity: str = "densenet",
                              activation: str = "swish",
                              saved: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None,
                              need_dx: bool = True,
                              need_dw: Optional[Sequence[bool]] = None,
                              need_db: Optional[Sequence[bool]] = None):
    """``(dx, dws, dbs)`` of ``<dense_stack_members(x, ws, bs), g>``, each
    with the member axis, None where not asked for (``need_*``, all by
    default). On a CUDA tensor the backward kernels launch once for all
    members, from the forward's ``saved``: ``(feature (densenet) or x,
    zs)``, ``zs`` the pre-activations ``dense_stack_members`` wrote; on a
    CPU tensor the members twin, ``dense_stack_members_grads_ref``."""
    n = len(ws)
    need_dw = [True] * n if need_dw is None else list(need_dw)
    need_db = [True] * n if need_db is None else list(need_db)
    if x.device.type == "cpu":
        dx, dws, dbs = dense_stack_members_grads_ref(
            x, ws, bs, g, connectivity=connectivity, activation=activation)
        return (dx if need_dx else None,
                [d if k else None for d, k in zip(dws, need_dw)],
                [d if k else None for d, k in zip(dbs, need_db)])
    if saved is None:
        raise ValueError("dense_stack_members_grads on the card needs the "
                         "forward's saved (feature or x, zs)")
    return _kernel_backward(saved, [_stacked(w, 2) for w in ws],
                            _stacked(g, 2), connectivity, activation,
                            need_dx, need_dw, need_db)


@torch.library.custom_op("repro_torch::dense_stack_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, ws: List[torch.Tensor],
            bs: List[torch.Tensor], connectivity: str, activation: str,
            with_zs: bool) -> List[torch.Tensor]:
    """``[feature]``, or ``[feature, zs]`` for the backward (zs empty on the
    CPU, whose backward recomputes), of one stack; its vmap rule runs E
    members at once."""
    m, n = x.shape[0], len(ws)
    if x.device.type == "cpu":
        out = dense_stack_ref(x, ws, bs, connectivity=connectivity,
                              activation=activation)
        return [out, x.new_empty((m, 0))] if with_zs else [out]
    zs = torch.empty((m, n * ws[0].shape[-1]), device=x.device,
                     dtype=torch.float32) if with_zs else None
    out = _kernel_forward(x.contiguous(), ws, bs, connectivity, activation,
                          zs)
    return [out, zs] if with_zs else [out]


def _grads_list(grads, need_dx, need_dw, need_db) -> List[torch.Tensor]:
    """The asked-for gradients of ``(dx, dws, dbs)`` as one flat list."""
    dx, dws, dbs = grads
    return ([dx] if need_dx else []) + \
        [d for d, k in zip(dws, need_dw) if k] + \
        [d for d, k in zip(dbs, need_db) if k]


@torch.library.custom_op("repro_torch::dense_stack_bwd", mutates_args=())
def _bwd_op(keep: torch.Tensor, zs: torch.Tensor, ws: List[torch.Tensor],
            bs: List[torch.Tensor], g: torch.Tensor, connectivity: str,
            activation: str, need_dx: bool, need_dw: List[bool],
            need_db: List[bool]) -> List[torch.Tensor]:
    """The asked-for gradients of one stack, in the order dx, dW_i, db_i,
    from the forward's ``keep`` (the feature for densenet, x else) and
    ``zs``; its vmap rule runs E members at once."""
    d0 = ws[0].shape[0]
    if keep.device.type == "cpu":
        x = keep[:, :d0] if connectivity == "densenet" else keep
        grads = dense_stack_grads_ref(x, ws, bs, g,
                                      connectivity=connectivity,
                                      activation=activation)
    else:
        grads = _kernel_backward((keep, zs), ws, g, connectivity,
                                 activation, need_dx, need_dw, need_db)
    return _grads_list(grads, need_dx, need_dw, need_db)


def _fwd_vmap(info, in_dims, x, ws, bs, connectivity, activation, with_zs):
    e = info.batch_size
    x = members_first(x, in_dims[0], e)
    ws = [members_first(w, d, e) for w, d in zip(ws, in_dims[1])]
    bs = [members_first(b, d, e) for b, d in zip(bs, in_dims[2])]
    m, n = x.shape[1], len(ws)
    zs = None
    if with_zs:
        zs = torch.empty((e, m, 0 if x.device.type == "cpu"
                          else n * ws[0].shape[-1]),
                         device=x.device, dtype=torch.float32)
    out = dense_stack_members(x, ws, bs, connectivity=connectivity,
                              activation=activation, zs=zs)
    outs = [out, zs] if with_zs else [out]
    return outs, [0] * len(outs)


def _bwd_vmap(info, in_dims, keep, zs, ws, bs, g, connectivity, activation,
              need_dx, need_dw, need_db):
    e = info.batch_size
    keep = members_first(keep, in_dims[0], e)
    zs = members_first(zs, in_dims[1], e)
    ws = [members_first(w, d, e) for w, d in zip(ws, in_dims[2])]
    bs = [members_first(b, d, e) for b, d in zip(bs, in_dims[3])]
    g = members_first(g, in_dims[4], e)
    if keep.device.type == "cpu":
        # the members twin as E calls of the solo op (each the solo plain
        # backward): torch.func.vjp runs inside the op, not in this rule
        per = [_bwd_op(keep[i], zs[i], [w[i] for w in ws],
                       [b[i] for b in bs], g[i], connectivity, activation,
                       need_dx, need_dw, need_db) for i in range(e)]
        out = [torch.stack(t) for t in zip(*per)]
    else:
        out = _grads_list(_kernel_backward(
            (_stacked(keep, 2), zs), [_stacked(w, 2) for w in ws],
            _stacked(g, 2), connectivity, activation, need_dx, need_dw,
            need_db), need_dx, need_dw, need_db)
    return out, [0] * len(out)


torch.library.register_vmap("repro_torch::dense_stack_fwd", _fwd_vmap)
torch.library.register_vmap("repro_torch::dense_stack_bwd", _bwd_vmap)


class _StackFn(torch.autograd.Function):
    """The stack under ``torch.func`` (``dense_stack`` inside a transform):
    the forward and backward custom ops, whose vmap rules take the member
    kernels; the function's own vmap rule is generated from theirs. The
    backward computes only what the transform asks for
    (``needs_input_grad``: a constant weight's dW is skipped)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, connectivity, activation, *params):
        n = len(params) // 2
        out, zs = _fwd_op(x, list(params[:n]), list(params[n:]),
                          connectivity, activation, True)
        return out, zs

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, connectivity, activation, *params = inputs
        out, zs = output
        ctx.connectivity, ctx.activation = connectivity, activation
        ctx.mark_non_differentiable(zs)
        ctx.save_for_backward(out if connectivity == "densenet" else x, zs,
                              *params)

    @staticmethod
    def backward(ctx, g, _gzs):
        keep, zs, *params = ctx.saved_tensors
        n = len(params) // 2
        need = ctx.needs_input_grad
        need_dx, need_dw, need_db = need[0], need[3:3 + n], need[3 + n:]
        grads = iter(_bwd_op(
            keep.detach(), zs.detach(), [p.detach() for p in params[:n]],
            [p.detach() for p in params[n:]], g.detach(), ctx.connectivity,
            ctx.activation, need_dx, list(need_dw), list(need_db)))
        dx = next(grads) if need_dx else None
        dws = [next(grads) if k else None for k in need_dw]
        dbs = [next(grads) if k else None for k in need_db]
        return (dx, None, None, *dws, *dbs)


def _transformed(x: torch.Tensor, ws, bs, connectivity: str,
                 activation: str) -> torch.Tensor:
    """``dense_stack`` of 2-D ``x`` inside a ``torch.func`` transform."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *ws, *bs)):
        return _StackFn.apply(x, connectivity, activation, *ws, *bs)[0]
    return _fwd_op(x, list(ws), list(bs), connectivity, activation,
                   False)[0]


def dense_stack(x: torch.Tensor, ws: Sequence[torch.Tensor],
                bs: Sequence[torch.Tensor], *, connectivity: str = "densenet",
                activation: str = "swish") -> torch.Tensor:
    """Feature of the L-layer stack: the kernels for CUDA tensors, the plain
    version for CPU tensors, the member route inside a ``torch.func``
    transform (see the module docstring)."""
    _validate(connectivity, activation, ws, bs)
    d0, u = x.shape[-1], ws[0].shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_stack runs on cuda (kernel) or cpu (plain "
                         f"version), not {x.device}")
    if torch._C._functorch.maybe_current_level() is not None:
        out = _transformed(x2, ws, bs, connectivity, activation)
    elif x.device.type == "cpu":
        out = dense_stack_ref(x2, ws, bs, connectivity=connectivity,
                              activation=activation)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2, *ws, *bs)):
        out = _StackKernel.apply(x2.contiguous(), connectivity, activation,
                                 *ws, *bs)
    else:
        out = _kernel_forward(x2.contiguous(), ws, bs, connectivity,
                              activation)
    return out.reshape(*lead, feature_dim(connectivity, len(ws), d0, u))
