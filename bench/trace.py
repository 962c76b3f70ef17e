"""What a ``torch.profiler`` capture says: over the short steady
sub-window in the span ``WINDOW``, the device's busy time (the union of
its operations' intervals, so kernels that overlap count once), the
program's host spans, and the breakdown the result line carries (the
device operations that took most time, and the longest idle gaps by the
host span open at their start); and for each probe span (``PROBE`` and
its name, a call repeated between synchronizes) the device's busy time
a call."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

Interval = Tuple[float, float]
WINDOW = "bench.window"
PROBE = "bench.probe:"


def union(spans: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(spans: List[Interval]) -> float:
    return sum(b - a for a, b in union(spans))


def read(prof, window_s: float, supersteps: int, reps: int) -> dict:
    """The capture as plain data: the sub-window's ``kernels`` and program
    ``spans`` as ``(name, start_us, end_us)``, ``busy_s``, ``window_s``,
    ``supersteps``, and ``probes`` (``{name: device seconds a call}``)."""
    dev = torch.autograd.DeviceType.CUDA
    kernels, spans = [], []
    events = list(prof.events())
    host_names = {e.name for e in events if e.device_type != dev}
    for e in events:
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != dev:
            spans.append(rec)
        # a host span's range mirrored on the device timeline is no
        # device operation
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name in host_names):
            kernels.append(rec)
    inside = lambda recs, a, b: [r for r in recs if a <= r[1] <= b]
    probes = {}
    for n, a, b in spans:
        if n.startswith(PROBE):
            busy = covered([(c, d) for _, c, d in inside(kernels, a, b)])
            probes[n[len(PROBE):]] = busy / 1e6 / reps if busy else None
    a, b = next((a, b) for n, a, b in spans if n == WINDOW)
    kernels = inside(kernels, a, b)
    spans = [s for s in inside(spans, a, b) if not s[0].startswith("bench.")]
    busy = covered([(a, b) for _, a, b in kernels]) / 1e6
    return {"kernels": kernels, "spans": spans, "busy_s": busy,
            "window_s": window_s, "supersteps": supersteps,
            "probes": probes}


def self_seconds(profile: dict, name: str, prefix: str = "repro.") -> float:
    """Summed self time of the host spans ``name``: each span less the
    part of it that nested spans whose names start with ``prefix``
    cover."""
    own = [(a, b) for n, a, b in profile["spans"] if n == name]
    kids = [(a, b) for n, a, b in profile["spans"]
            if n != name and n.startswith(prefix)]
    total = 0.0
    for a, b in own:
        inner = [(max(a, c), min(b, d)) for c, d in kids if c < b and d > a
                 and (c, d) != (a, b)]
        total += (b - a) - covered(inner)
    return total / 1e6


def span_seconds(profile: dict, names) -> float:
    return sum(b - a for n, a, b in profile["spans"] if n in names) / 1e6


def breakdown(profile: dict, top: int = 10) -> dict:
    """``device_ops``: the device operations with the most time, by name;
    ``idle_gaps``: the idle time between device operations by the
    innermost host span open where each gap starts."""
    by_op: Dict[str, float] = defaultdict(float)
    for n, a, b in profile["kernels"]:
        by_op[n] += (b - a) / 1e6
    busy = union([(a, b) for _, a, b in profile["kernels"]])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    spans = sorted(profile["spans"], key=lambda s: s[1])
    by_host: Dict[str, float] = defaultdict(float)
    active: List[Tuple[str, float, float]] = []
    j = 0
    for a, b in gaps:                   # in time order: sweep the spans
        while j < len(spans) and spans[j][1] <= a:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[2] > a]
        name = min(active, key=lambda s: s[2] - s[1])[0] if active \
            else "(no host span)"
        by_host[name] += (b - a) / 1e6
    rank = lambda d: [[k, v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
