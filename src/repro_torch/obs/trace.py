"""Trace & profiling hooks: named spans, phase stamps inside the superstep
graph, and the ``ObsSpec.trace = N`` chunk capture (port of
``repro/obs/trace.py`` on ``torch.profiler``).

``annotate(name)`` marks the wall-clock extent of host work (chunk
dispatch, eval, srank, checkpoint save and restore) as a
``torch.profiler.record_function`` span, which a captured trace shows on
the host timeline, and, with a CUDA card present, as an NVTX range too.
The span names are the reference's (``repro.chunk_dispatch``,
``repro.fleet_chunk_dispatch``, ``repro.srank``, ``repro.fleet_srank``,
``repro.eval``, ``repro.fleet_eval``, ``repro.ckpt.save``,
``repro.ckpt.restore``, ``repro.replay.host_add``,
``repro.replay.host_sample``, ``repro.replay.host_update_prio``), and
the port's own waits of the host replay on the card
(``repro_torch.replay.wait_rows`` after segment A,
``repro_torch.replay.wait_prio`` after segment B): another prefix, so
that a reader which subtracts the nested ``repro.*`` spans from the
chunk dispatch keeps the waits in it.

``stamp(phase)`` marks a phase boundary of the superstep ON THE CARD: in
a ``StepGraph`` captured with stamps (``Trainer.stamp_phases``), it
captures a one-thread kernel (``csrc/phase_stamp.cu``,
``phase_stamp_<phase>``) that writes ``%globaltimer`` into the graph's
``PhaseStamps`` ring; anywhere else, and always on the CPU, it does
nothing. The phases (``PHASES``) partition the superstep: ``collect``
(from its start to the replay add: the draws, the actors' policy and env
step, the n-step ring; a host-replay run's whole segment A), ``replay``
(the device replay's add and sample, then its refresh with the sampled
rows' staleness), ``update`` (the losses, forward and backward, less
AdamW), ``adamw`` (each ``adamw_update`` call), ``copyback`` (the obs
stream row and the copy into the static state) and ``gap`` (from the
superstep's last stamp to the next one's first, and in a host-replay run
from segment A's end to B's start: the chunk epilogue's device work and
the card waiting on the host). ``PhaseStamps.read`` turns the ring into
ms a superstep on the host's clock (``phase_table``).

``TraceCapture`` implements ``ObsSpec.trace = N``: the first ``begin()``
starts a ``torch.profiler.profile`` (CPU activity, and CUDA with a card),
each ``end()`` counts one completed chunk, and the capture stops after
``N`` chunks (or at ``finish()``, whichever comes first) and writes a
Chrome trace into ``<log_dir>/trace/``. Profiler failures are reported
through ``status`` instead of killing the run: tracing is a diagnostic,
never a correctness dependency. A run with ``trace = N`` also captures
its superstep graph with phase stamps.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "phase_stamp.cu"
# the order of the kernels' phase ids in csrc/phase_stamp.cu
PHASES = ("collect", "replay", "update", "adamw", "copyback", "gap")
MAX_SLOTS = 32       # stamps a superstep (SAC with OFENet: 14)
MAX_ROWS = 1 << 16   # 16 MiB of ring at most, whatever the chunks' length

_ACTIVE: Optional["PhaseStamps"] = None


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host span for the profiler (and NVTX on a CUDA card)."""
    with contextlib.ExitStack() as spans:
        spans.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            spans.enter_context(torch.cuda.nvtx.range(name))
        yield


# ------------------------------------------------------------ phase stamps

def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("phase_stamp", [SOURCE])
    if lib.phase_stamp.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.phase_stamp.argtypes = [i, p, i, p, p, i, i, i, p]
        lib.phase_stamp.restype = ctypes.c_int
    return lib


def _launch(phase: str, ring: torch.Tensor, cursor: torch.Tensor,
            counter: Optional[torch.Tensor], slot: int) -> None:
    """One stamp kernel on the current stream: ``ring[row, slot]`` gets
    the card's ns, the row picked from ``counter`` when given."""
    dev = ring.device
    wide = counter is not None and counter.element_size() == 8
    with torch.cuda.device(dev):
        err = _library().phase_stamp(
            PHASES.index(phase), ring.data_ptr(), ring.shape[1],
            cursor.data_ptr(), None if counter is None else
            counter.data_ptr(), int(wide), ring.shape[0], slot,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase_stamp launch failed: CUDA error {err} "
                           f"(phase {phase}, slot {slot})")


class PhaseStamps:
    """The ring of one stamped ``StepGraph`` and what reads it.

    ``ring`` is ``(rows, MAX_SLOTS)`` int64 on the card: a row a superstep,
    picked by the superstep's first stamp from ``counter`` (the graph's
    superstep counter, ``StepGraph._now()``) modulo ``rows`` (``StepGraph``
    asks for two of the trainer's longest chunks; at most ``MAX_ROWS``); ``schedule``
    the phase that starts at each slot, in capture order. ``launched``
    holds the host's ``time.perf_counter_ns()`` at each replay's launch
    (``launch()``), ``replays`` their count since the ring was made or
    ``reset``. At construction one eager stamp between two host clock
    reads, the card synchronized around it, maps the card's clock onto the
    host's: ``offset_ns`` (card minus host) within ``offset_err_ns``."""

    def __init__(self, counter: torch.Tensor, rows: int):
        dev = counter.device
        if dev.type != "cuda":
            raise ValueError(f"phase stamps run on a CUDA card, not {dev}")
        self.counter = counter
        rows = min(rows, MAX_ROWS)
        self.ring = torch.zeros((rows, MAX_SLOTS), dtype=torch.int64,
                                device=dev)
        self.cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.schedule: List[str] = []
        self.launched: collections.deque = collections.deque(maxlen=rows)
        self.replays = 0
        self.offset_ns, self.offset_err_ns = self._calibrate()

    def _calibrate(self, tries: int = 5):
        dev = self.ring.device
        out = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        row = torch.zeros((1,), dtype=torch.int32, device=dev)
        pairs = []
        for _ in range(tries + 1):          # the first loads the kernel
            torch.cuda.synchronize(dev)
            h0 = time.perf_counter_ns()
            _launch("gap", out, row, None, 0)
            torch.cuda.synchronize(dev)
            h1 = time.perf_counter_ns()
            pairs.append((int(out.item()) - (h0 + h1) // 2, (h1 - h0) / 2))
        return min(pairs[1:], key=lambda p: p[1])

    def stamp(self, phase: str) -> None:
        """Capture the next slot's stamp (the first picks the row; the
        kernel refuses a slot past ``MAX_SLOTS``)."""
        slot = len(self.schedule)
        _launch(phase, self.ring, self.cursor,
                self.counter if slot == 0 else None, slot)
        self.schedule.append(phase)

    def launch(self) -> None:
        """Record the host's clock at a replay's launch."""
        self.launched.append(time.perf_counter_ns())
        self.replays += 1

    def reset(self) -> None:
        """Forget the replays so far (a state loaded into the graph moves
        its counter)."""
        self.launched.clear()
        self.replays = 0

    def read(self, n: int) -> dict:
        """``phase_table`` of the last ``n`` replays, or of as many as ran
        since the ring was made or ``reset`` and it holds, when fewer (the
        table's ``supersteps``); at least 2. Read after a synchronize in
        one copy to the host."""
        n = min(n, self.replays, self.ring.shape[0])
        if n < 2:
            raise ValueError(f"phases need 2 stamped replays, "
                             f"{self.replays} ran")
        torch.cuda.synchronize(self.ring.device)
        now = int(self.counter.item())
        ring = self.ring.cpu().numpy()
        return phase_table(ring_rows(ring, now, n)[:, :len(self.schedule)],
                           self.schedule, list(self.launched)[-n:],
                           self.offset_ns, self.offset_err_ns)


def ring_rows(ring: np.ndarray, now: int, n: int) -> np.ndarray:
    """The rows of the last ``n`` supersteps in order, the counter having
    reached ``now`` (the last superstep's row is ``now - 1`` mod rows)."""
    return ring[(now - n + np.arange(n)) % ring.shape[0]]


def phase_table(rows: np.ndarray, schedule: Sequence[str],
                launched_ns: Optional[Sequence[int]] = None,
                offset_ns: int = 0, offset_err_ns: float = 0.0) -> dict:
    """Device ms a superstep of each phase from ``rows`` ``(n, S)`` (card
    ns, the n supersteps in order, ``schedule[k]`` the phase that starts
    at slot k, the last a ``gap``): each phase's intervals summed in a row
    and averaged over the n rows; ``step_gap`` the ``gap`` intervals inside
    a row over the n rows plus, over the n - 1 pairs, each row's last
    stamp to the next row's first. ``lead_ms``: each superstep's first
    stamp on the host's clock (card ns less ``offset_ns``) less its launch
    ``launched_ns``; ``clock_uncertainty_ms`` bounds the mapping.
    Returns ``{phase: ms, ..., "step_gap": ms, "supersteps": n,
    "lead_ms": [...], "clock_uncertainty_ms": ...}``."""
    t = np.asarray(rows, np.int64)
    n, s = t.shape
    if len(schedule) != s or schedule[-1] != "gap":
        raise ValueError(f"a schedule of {s} stamps ending in 'gap', got "
                         f"{list(schedule)}")
    if n < 2 or (t <= 0).any() or (np.diff(t.reshape(-1)) < 0).any():
        raise ValueError("the rows are not n >= 2 stamped supersteps in "
                         "order")
    d = np.diff(t, axis=1) / 1e6
    ms: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
    for k, phase in enumerate(schedule[:-1]):
        ms[phase] += float(d[:, k].mean())
    ms["gap"] += float((t[1:, 0] - t[:-1, -1]).mean()) / 1e6
    out = {p: ms[p] for p in PHASES if p != "gap"}
    out.update(step_gap=ms["gap"], supersteps=n,
               clock_uncertainty_ms=offset_err_ns / 1e6)
    if launched_ns is not None:
        out["lead_ms"] = ((t[:, 0] - offset_ns - np.asarray(
            launched_ns, np.int64)) / 1e6).tolist()
    return out


@contextlib.contextmanager
def stamping(stamps: Optional[PhaseStamps]) -> Iterator[None]:
    """``stamp`` captures into ``stamps`` inside the block (``StepGraph``
    opens it around its capture; ``None``: stamps stay off)."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, stamps
    try:
        yield
    finally:
        _ACTIVE = outer


def stamp(phase: str) -> None:
    """Mark the start of ``phase`` on the card: a no-op unless a
    ``StepGraph`` capture with stamps is in progress (never on the
    CPU)."""
    if _ACTIVE is not None and _capture_in_progress():
        _ACTIVE.stamp(phase)


def _capture_in_progress() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class TraceCapture:
    """Capture a ``torch.profiler`` trace of the first ``n_chunks`` chunks.

    status: "idle" (n_chunks == 0) | "pending" | "active" | "done" |
    "failed: <err>". ``path`` is the Chrome trace written at the stop
    (``<trace_dir>/trace-<pid>.json``)."""

    def __init__(self, n_chunks: int, trace_dir: str):
        self.n_chunks = int(n_chunks)
        self.trace_dir = str(trace_dir)
        self.remaining = self.n_chunks
        self.active = False
        self.status = "idle" if self.n_chunks == 0 else "pending"
        self.path: Optional[str] = None
        self._prof: Optional[torch.profiler.profile] = None

    def begin(self) -> None:
        """Start the trace at the first chunk; later calls are no-ops."""
        if self.status != "pending" or self.active:
            return
        try:
            Path(self.trace_dir).mkdir(parents=True, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.active = True
            self.status = "active"
        except Exception as e:
            self._prof = None
            self.status = f"failed: {e}"

    def end(self) -> None:
        """Count one completed chunk; stop after ``n_chunks``."""
        if not self.active:
            return
        self.remaining -= 1
        if self.remaining <= 0:
            self._stop()

    def finish(self) -> None:
        """Force-stop (run ended before ``n_chunks`` chunks completed)."""
        if self.active:
            self._stop()

    def _stop(self) -> None:
        self.active = False
        prof, self._prof = self._prof, None
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(self.trace_dir, f"trace-{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.path = path
            self.status = "done"
        except Exception as e:
            self.status = f"failed: {e}"
