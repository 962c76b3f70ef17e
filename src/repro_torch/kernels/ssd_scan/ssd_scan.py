"""SSD intra-chunk kernel, the Mamba2 dual form (port of
``repro/kernels/ssd_scan/ssd_scan.py``).

``ssd_chunk_dual`` launches ``csrc/ssd_scan.cu`` once on CUDA tensors, or
raises: there is no fallback. On CPU tensors it runs
``ref.ssd_chunk_dual_ref``. Each launch adds one to ``launch_count()``.

The kernel reads every operand through strides (unit stride along N and
P), so callers may hand over views: ``ops.ssd_chunked_kernel`` passes the
chunks of its ``(B, S, H, P)`` sequence and has the output written into a
``(B, S, H, P)`` tensor through ``out``. The reference's ``interpret``
flag does not carry over. c and b are float32 or bfloat16, x float32 or
bfloat16 (the output takes x's dtype); cum, dt, the state and D are read
as float32. P is at most 128; N as far as ``smem_bytes`` fits a block.
``PLAN`` is the kernel's heads a block, warps, s-tile width and exp
form, the card sweep's pick (``launch/bwd_sweep.py --only ssd``); the library is built
with it as constants (``build_defines``), so the wrapper has no runtime
knob.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_P = 128
MAX_SMEM = 232448                      # bytes of shared memory a block may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (heads a block, warps a block, s-tile width, fast exp): a block owns a
# 64-row t-tile of one cell for a group of heads, which share its C B^T
# tiles, and walks s-tiles of 32 or 64 columns; 4 warps hold a head's whole
# P, 8 split it in two; the decays' e^x is ``__expf`` if fast exp is 1, else
# ``expf``
PLAN = (2, 4, 32, 1)

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def build_defines(plan=PLAN) -> Tuple[str, ...]:
    """The ``-D`` flags that fix ``ssd_scan.cu``'s heads a block, warps,
    s-tile width and exp form."""
    heads, warps, bs, fast_exp = plan
    return (f"-DSSD_HG={heads}", f"-DSSD_WARPS={warps}", f"-DSSD_BS={bs}",
            f"-DSSD_FAST_EXP={int(fast_exp)}")


def p_width(p: int) -> int:
    """The kernel's P width for head width ``p``: 32, 64 or 128 (its x
    tile and state span it, zero past P)."""
    return 32 if p <= 32 else 64 if p <= 64 else MAX_P


def smem_bytes(n: int, p: int, c_bytes: int, x_bytes: int,
               bs: int = PLAN[2]) -> int:
    """``ssd_scan.cu``'s ``layout(n, pmax, ...).total``: the dynamic shared
    memory of a block at state width N and head width P, for c/b and x
    elements of ``c_bytes`` and ``x_bytes`` and s-tiles of ``bs`` columns.
    The 64-row C tile, then 2 ring stages, each B_s, x, cum_s and dt_s, or
    the state; rows padded 16 bytes past a multiple of 32 elements."""
    n32, pmax = -(-n // 32) * 32, p_width(p)
    ldc, ldx, lds = n32 + 16 // c_bytes, pmax + 16 // x_bytes, n32 + 4
    work = bs * ldc * c_bytes + bs * ldx * x_bytes + 2 * bs * 4
    return 64 * ldc * c_bytes + 2 * max(work, pmax * lds * 4)


def _library(name: str = "ssd_scan", defines=None) -> ctypes.CDLL:
    """The library built with ``defines`` (``build_defines()``'s, the
    picked plan, when None), its entry points declared."""
    from repro_torch.kernels import load_library
    lib = load_library(name, [SOURCE], defines=defines or build_defines())
    fn = lib.ssd_chunk_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ssd_kernel_attrs.argtypes = [i, i, i, p, p]
        lib.ssd_kernel_attrs.restype = ctypes.c_int
    return lib


def _launch(c, b, x, cum, dt, state_in, d_skip, out, entry=None) -> None:
    """One launch of ``entry`` (``ssd_chunk_fwd``'s arguments; the picked
    library's when None) on checked operands; raises on a CUDA error."""
    g, q, n = c.shape
    h, p = x.shape[1], x.shape[-1]
    for name, t in (("c", c), ("b", b), ("x", x), ("cum", cum), ("dt", dt),
                    ("state_in", state_in), ("d_skip", d_skip),
                    ("out", out)):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk_dual: {name} on {t.device}, x on "
                             f"{x.device}")
    if c.dtype != b.dtype or c.dtype not in _DTYPE_CODE \
            or x.dtype not in _DTYPE_CODE or out.dtype != x.dtype:
        raise TypeError(f"ssd_chunk_dual kernel takes c and b of one dtype "
                        f"and x (and out) each float32 or bfloat16; got c "
                        f"{c.dtype}, b {b.dtype}, x {x.dtype}, out "
                        f"{out.dtype}")
    for name, t in (("c", c), ("b", b), ("x", x), ("state_in", state_in),
                    ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunk_dual: {name} needs unit stride in "
                             f"its last dimension")
    if p > MAX_P:
        raise ValueError(f"ssd_chunk_dual kernel takes P up to {MAX_P}, got "
                         f"{p}")
    need = smem_bytes(n, p, c.element_size(), x.element_size())
    if need > MAX_SMEM:
        raise ValueError(f"ssd_chunk_dual kernel: N={n}, P={p} needs {need} "
                         f"bytes of shared memory a block, over {MAX_SMEM}")
    # float32 views of the decays, state and skip (no copy when they are)
    cum, dt = cum.float(), dt.float()
    state_in, d_skip = state_in.float(), d_skip.float().contiguous()
    strides = [*c.stride()[:2], *b.stride()[:2], *x.stride()[:3],
               *out.stride()[:3], *cum.stride(), *dt.stride(),
               *state_in.stride()[:3]]
    entry = entry or _library().ssd_chunk_fwd
    with torch.cuda.device(x.device):
        err = entry(
            _DTYPE_CODE[c.dtype], _DTYPE_CODE[x.dtype], c.data_ptr(),
            b.data_ptr(), x.data_ptr(), cum.data_ptr(), dt.data_ptr(),
            state_in.data_ptr(), d_skip.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 19)(*strides), g, h, q, n, p,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error "
                           f"{err} (G={g}, H={h}, Q={q}, N={n}, P={p})")


def ssd_chunk_dual(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   cum: torch.Tensor, dt: torch.Tensor,
                   state_in: torch.Tensor, d_skip: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(cell, head) chunk outputs. c, b: (G, Q, N); x: (G, H, Q, P);
    cum, dt: (G, H, Q); state_in: (G, H, P, N); d_skip: (H,). G =
    batch * n_chunks. Returns y (G, H, Q, P) in x's dtype, written into
    ``out`` (any strides, unit stride along P) when given."""
    g, q, n = c.shape
    h, p = x.shape[1], x.shape[-1]
    want = {"b": (b, (g, q, n)), "x": (x, (g, h, q, p)),
            "cum": (cum, (g, h, q)), "dt": (dt, (g, h, q)),
            "state_in": (state_in, (g, h, p, n)), "d_skip": (d_skip, (h,))}
    if out is not None:
        want["out"] = (out, (g, h, q, p))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk_dual: {name} {tuple(t.shape)}, want "
                             f"{shape}")
    if 0 in c.shape or 0 in x.shape:
        raise ValueError("ssd_chunk_dual: empty chunk, head or width")
    if x.device.type == "cpu":
        y = ref.ssd_chunk_dual_ref(c, b, x, cum, dt, state_in, d_skip)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_dual runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device}")
    if out is None:
        out = torch.empty((g, h, q, p), device=x.device, dtype=x.dtype)
    _launch(c, b, x, cum, dt, state_in, d_skip, out)
    _count_launch()
    return out
