"""Trace & profiling hooks: named spans + the ``ObsSpec.trace = N`` chunk
capture (port of ``repro/obs/trace.py`` on ``torch.profiler``).

``annotate(name)`` marks the wall-clock extent of host work (chunk
dispatch, eval, srank, checkpoint save and restore) as a
``torch.profiler.record_function`` span, which a captured trace shows on
the host timeline, and, with a CUDA card present, as an NVTX range too.
The span names are the reference's (``repro.chunk_dispatch``,
``repro.srank``, ``repro.eval``, ``repro.ckpt_save``, ``repro.ckpt.save``,
``repro.ckpt.restore``).

``TraceCapture`` implements ``ObsSpec.trace = N``: the first ``begin()``
starts a ``torch.profiler.profile`` (CPU activity, and CUDA with a card),
each ``end()`` counts one completed chunk, and the capture stops after
``N`` chunks (or at ``finish()``, whichever comes first) and writes a
Chrome trace into ``<log_dir>/trace/``. Profiler failures are reported
through ``status`` instead of killing the run: tracing is a diagnostic,
never a correctness dependency.
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host span for the profiler (and NVTX on a CUDA card)."""
    with contextlib.ExitStack() as spans:
        spans.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            spans.enter_context(torch.cuda.nvtx.range(name))
        yield


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
