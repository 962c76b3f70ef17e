"""Pluggable metric sinks behind the ``MetricWriter`` protocol (copy of
``repro/obs/writers.py``: the same classes, row schema and file names, so a
run directory written by either package reads in the other's report).

A writer consumes *rows*: plain dicts with at least ``kind`` ("train" |
"eval" | "event") and ``step`` (absolute learner step); every other value is
a JSON scalar (see ``repro_torch.obs`` for the full schema). Writers never
see tensors — the stream layer (``repro_torch.obs.stream.ObsRun``) converts
to host floats before handing rows over.

Implementations:

* ``JsonlWriter``  — one JSON object per line, append mode (resume-friendly:
  a restored run keeps appending; readers take the LAST row per (kind, step)
  when a file holds replayed steps).
* ``CsvWriter``    — flat CSV; the column set is fixed by the first row
  (later rows fill missing columns with "" and drop unknown ones).
* ``MemoryWriter`` — in-process list of rows (tests, notebooks, report).
* ``BufferedWriter`` — the async host writer: a bounded queue + one daemon
  thread fanning rows out to the wrapped sinks, so file I/O never sits on
  the training thread between chunks. ``drain()`` blocks until the queue
  is empty and re-raises any sink error — ``Experiment.save`` calls it
  right after draining the card, so the metric files are consistent with
  the checkpoint.
"""
from __future__ import annotations

import csv
import json
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Protocol, Sequence

Row = Dict[str, object]

SINKS = ("jsonl", "csv", "memory")

METRICS_JSONL = "metrics.jsonl"
METRICS_CSV = "metrics.csv"


class MetricWriter(Protocol):
    """The sink protocol: ordered row batches, explicit flush/close."""

    def write(self, rows: Sequence[Row]) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


class JsonlWriter:
    """One JSON object per line in ``<dir>/metrics.jsonl`` (append mode)."""

    def __init__(self, path: str):
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        self.path = str(p)
        self._f = open(self.path, "a", encoding="utf-8")

    def write(self, rows: Sequence[Row]) -> None:
        for r in rows:
            self._f.write(json.dumps(r, default=float) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class CsvWriter:
    """Flat CSV; the header is pinned by the first row written."""

    def __init__(self, path: str):
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        self.path = str(p)
        self._f = open(self.path, "a", encoding="utf-8", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def write(self, rows: Sequence[Row]) -> None:
        for r in rows:
            if self._writer is None:
                self._writer = csv.DictWriter(
                    self._f, fieldnames=list(r), extrasaction="ignore",
                    restval="")
                if self._f.tell() == 0:
                    self._writer.writeheader()
            self._writer.writerow(r)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class MemoryWriter:
    """Rows in a list; ``rows`` is the live accumulating view."""

    def __init__(self):
        self.rows: List[Row] = []

    def write(self, rows: Sequence[Row]) -> None:
        self.rows.extend(dict(r) for r in rows)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_writer(kind: str, log_dir: str) -> MetricWriter:
    if kind == "jsonl":
        return JsonlWriter(str(Path(log_dir) / METRICS_JSONL))
    if kind == "csv":
        return CsvWriter(str(Path(log_dir) / METRICS_CSV))
    if kind == "memory":
        return MemoryWriter()
    raise ValueError(f"unknown sink {kind!r}; have {SINKS}")


_CLOSE = object()


class BufferedWriter:
    """Async fan-out: one daemon thread drains a bounded queue into every
    wrapped sink, preserving submission order (single consumer).

    Transient IO errors (``OSError`` — a full disk briefly clearing, NFS
    hiccups, an interrupted write) are retried per sink with bounded
    exponential backoff (``retries`` x ``backoff * 2**attempt``), so a
    metric blip cannot kill a training run. Only the FAILING sink's write
    is retried — healthy sinks never see duplicate rows. Errors that
    outlive the retry budget, and non-OSError sink bugs (retried zero
    times), are captured and re-raised at the next ``drain()`` /
    ``close()`` so they surface on the training thread, not in a thread
    traceback nobody reads."""

    def __init__(self, sinks: Iterable[MetricWriter], maxsize: int = 256,
                 retries: int = 3, backoff: float = 0.05):
        self.sinks = list(sinks)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-obs-writer")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _CLOSE:
                    return
                if self._exc is None:
                    for s in self.sinks:
                        self._write_with_retry(s, item)
            except BaseException as e:          # surfaced via drain()
                self._exc = e
            finally:
                self._q.task_done()

    def _write_with_retry(self, sink: MetricWriter,
                          rows: Sequence[Row]) -> None:
        for attempt in range(self.retries + 1):
            try:
                sink.write(rows)
                return
            except OSError:
                if attempt == self.retries:
                    raise               # permanent: surfaces at drain()
                time.sleep(self.backoff * (2 ** attempt))

    def write(self, rows: Sequence[Row]) -> None:
        if self._closed:
            raise RuntimeError("BufferedWriter is closed")
        if rows:
            self._q.put(list(rows))

    def drain(self) -> None:
        """Block until every queued row reached the sinks, then flush them.
        Re-raises the first sink error, if any."""
        self._q.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        for s in self.sinks:
            s.flush()

    def flush(self) -> None:
        self.drain()

    def close(self) -> None:
        if self._closed:
            return
        self._q.join()
        self._closed = True
        self._q.put(_CLOSE)
        self._thread.join(timeout=10)
        exc, self._exc = self._exc, None
        for s in self.sinks:
            s.close()
        if exc is not None:
            raise exc
