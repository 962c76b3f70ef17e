"""The in-loop metric stream: chunk flush, downsampling, counters, events
(port of ``repro/obs/stream.py``).

``ObsRun`` is the per-``Experiment`` observability engine. The scan loop
hands it whole chunks at a time — the per-step scalar stream the chunk
recorded (``Trainer.chunk_fn``'s ``out["stream"]``, one ``(n_steps,)``
host array per scalar; under the CUDA graph the graph itself writes each
superstep's row) — and ``flush_chunk`` downsamples against ABSOLUTE step
numbers (``step % log_every == 0``) before pushing rows to the buffered
async writer. Downsampling on the host from a stream recorded in full
keeps the superstep the same for every ``log_every`` and chunk length, so
obs knobs never perturb the bitwise resume contract. The python loop
calls ``log_train`` per step instead; both loops produce the same row set.

Rows (see ``repro_torch.obs`` for the schema) flow through one
``BufferedWriter`` fanning out to the spec's sinks; ``drain()`` empties the
queue and is called by ``Experiment.save`` once the card is drained.
``state()`` / ``load_state`` round-trip the stream cursor through
checkpoint metadata so a resumed run continues the stream where it left
off.

Fleet demux (``repro_torch.rl.sweep``): a fleet's chunk stream comes back
with a member axis; the fleet slices it per member and hands each member's
``(n_steps,)`` view to that member's own ``ObsRun``, made with
``member=<label>`` and a per-member ``log_dir`` subdirectory. Every row an
``ObsRun`` with a member label writes carries a ``"member"`` field, and
``repro_torch.obs.report`` accepts the sweep directory and merges them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import TraceCapture
from repro_torch.obs.writers import (BufferedWriter, MemoryWriter, Row,
                                     make_writer)


class ObsRun:
    """Owns the sinks, the downsampling cursor, counters and the trace hook
    for one experiment. Constructed from an ``ObsSpec``-shaped object
    (``enabled``/``log_every``/``sinks``/``trace``/``log_dir``); when
    ``enabled`` is False every method is a cheap no-op.

    ``member`` tags every row this run writes with a fleet member label;
    a solo run leaves it None and its rows are unchanged."""

    def __init__(self, spec, member: Optional[str] = None):
        self.spec = spec
        self.member = member
        self.enabled = bool(spec.enabled)
        self.log_every = int(spec.log_every)
        self.rows_written = 0
        self.events_written = 0
        self.last_train_step = 0
        self._writer: Optional[BufferedWriter] = None
        self._memory: Optional[MemoryWriter] = None
        self.trace = TraceCapture(
            spec.trace if self.enabled else 0,
            str(Path(spec.log_dir) / "trace") if spec.log_dir else "trace")
        if self.enabled:
            sinks = [make_writer(s, spec.log_dir) for s in spec.sinks]
            for s in sinks:
                if isinstance(s, MemoryWriter):
                    self._memory = s
            self._writer = BufferedWriter(sinks)

    # ------------------------------------------------------------- plumbing
    @property
    def rows(self) -> List[Row]:
        """The memory sink's rows (empty when no memory sink configured)."""
        return self._memory.rows if self._memory is not None else []

    def _emit(self, rows: Sequence[Row]) -> None:
        if self._writer is not None and rows:
            if self.member is not None:
                for r in rows:
                    r.setdefault("member", self.member)
            self._writer.write(rows)

    def drain(self) -> None:
        """Block until every queued row reached the sinks."""
        if self._writer is not None:
            self._writer.drain()

    def close(self) -> None:
        self.trace.finish()
        if self._writer is not None:
            self._writer.close()

    # ------------------------------------------------------------ train rows
    def flush_chunk(self, start_step: int,
                    stream: Mapping[str, np.ndarray]) -> None:
        """Downsample + write one chunk's per-step scalar stream.

        ``stream`` maps metric name -> ``(n_steps,)`` host array covering
        absolute steps ``start_step+1 .. start_step+n_steps``; rows are kept
        where ``step % log_every == 0`` (absolute, so re-chunking the same
        step sequence — eval stops, resume splits — never moves a row)."""
        if not self.enabled or not stream:
            return
        n = len(next(iter(stream.values())))
        steps = np.arange(start_step + 1, start_step + n + 1)
        keep = np.nonzero(steps % self.log_every == 0)[0]
        rows: List[Row] = []
        for i in keep:
            row: Row = {"kind": "train", "step": int(steps[i])}
            for k, v in stream.items():
                row[k] = float(v[i])
            rows.append(row)
        if rows:
            self.last_train_step = int(rows[-1]["step"])
            self.rows_written += len(rows)
            self._emit(rows)

    def log_train(self, step: int, scalars: Mapping[str, float]) -> None:
        """Per-step entry point (python loop). Applies the same absolute
        ``log_every`` filter as ``flush_chunk``."""
        if not self.enabled or step % self.log_every:
            return
        row: Row = {"kind": "train", "step": int(step)}
        row.update({k: float(v) for k, v in scalars.items()})
        self.last_train_step = int(step)
        self.rows_written += 1
        self._emit([row])

    # ------------------------------------------------------- eval + events
    def log_eval(self, step: int, ret: float,
                 scalars: Mapping[str, float]) -> None:
        if not self.enabled:
            return
        row: Row = {"kind": "eval", "step": int(step), "return": float(ret)}
        row.update({k: float(v) for k, v in scalars.items()})
        self.rows_written += 1
        self._emit([row])

    def log_event(self, event: str, step: int, **fields) -> None:
        """Structured one-off rows: chunk timings, run summaries, srank
        points, save/restore markers, trace status, guard actions."""
        if not self.enabled:
            return
        row: Row = {"kind": "event", "event": event, "step": int(step)}
        row.update({k: (float(v) if isinstance(v, (int, float, np.floating,
                                                   np.integer))
                        and not isinstance(v, bool) else v)
                    for k, v in fields.items()})
        self.events_written += 1
        self._emit([row])

    def chunk_event(self, start_step: int, stop_step: int,
                    wall_s: float) -> None:
        steps = stop_step - start_step
        self.log_event("chunk", step=stop_step, steps=steps, wall_s=wall_s,
                       steps_per_sec=steps / wall_s if wall_s > 0 else 0.0)

    # ------------------------------------------------------- checkpointing
    def state(self) -> Dict[str, int]:
        """The stream cursor persisted in checkpoint metadata."""
        return {"rows_written": self.rows_written,
                "events_written": self.events_written,
                "last_train_step": self.last_train_step}

    def load_state(self, st: Optional[Mapping]) -> None:
        if not st:
            return
        self.rows_written = int(st.get("rows_written", 0))
        self.events_written = int(st.get("events_written", 0))
        self.last_train_step = int(st.get("last_train_step", 0))
