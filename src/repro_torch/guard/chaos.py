"""Deterministic, step-addressed fault injection for the guard test matrix
(port of ``repro/guard/chaos.py``).

Every recovery path in ``repro_torch.guard`` is exercised by INJECTED
faults, not trusted: tests (and the supervisor's ``--chaos`` flag) arm one
of these and assert the documented recovery happened bit for bit. All
faults are deterministic — addressed by learner step or by a named commit
point, never by wall clock — so a failing chaos test replays exactly.

Faults:

* ``poison_params(handle, member=None)`` — host-side one-shot: writes NaN
  into the live agent params of an ``Experiment`` (or of one member of a
  ``Fleet``) between ``run()`` calls (in place: on the card under
  ``loop="scan"`` they are the graph's static state). The
  next chunk's stream/param checks detect it; because the poke is not part
  of the superstep, a skip/rollback recovery replays CLEAN.
* ``arm_nan_step(trainer, at_step)`` — persistent fault inside the
  superstep: params become NaN exactly when the agent's update counter
  hits ``at_step`` (a device-side ``torch.where``, so it is captured into
  the CUDA graph). Rolling back below ``at_step`` re-poisons on replay, so
  it tests ``halt`` and budget exhaustion, not successful recovery.
* ``kill_now()`` — SIGKILL the current process (no atexit, no cleanup).
* ``arm_kill_mid_save(store)`` — SIGKILL at the store's pre-commit seam:
  every checkpoint file staged and checksummed, the commit rename never
  happens. ``restore_latest`` must land on the previous good checkpoint.
* ``arm_swap_fault(server, fires=N)`` — die at the policy server's
  pre-flip seam: new params staged, the generation flip never happens;
  serving continues on the OLD generation.
* ``corrupt_checkpoint(path, mode)`` — bit-flip or truncate a COMMITTED
  checkpoint's payload without touching its manifest, so only checksum
  verification can catch it.
* ``FlakySink(sink, fails=N)`` — a metric sink whose first N writes raise
  a transient ``OSError`` (``fails=None``: forever), driving the
  ``BufferedWriter`` retry and permanent-error paths.
* ``OneShot(dir, name)`` — a filesystem latch (O_EXCL marker file) making
  a fault fire exactly once ACROSS PROCESS ATTEMPTS; ``OneShotN(n)`` the
  in-process, thread-safe latch firing at most n times.
"""
from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.common import tree_leaves, tree_map


class OneShot:
    """Cross-process single-fire latch: ``fire()`` is True exactly once per
    marker file (atomic ``O_CREAT|O_EXCL``), no matter how many worker
    attempts the supervisor spawns."""

    def __init__(self, directory: str, name: str):
        self.path = Path(directory) / f"chaos-{name}.fired"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def fired(self) -> bool:
        return self.path.exists()

    def fire(self) -> bool:
        """Atomically claim the latch; True for the single winning call."""
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True


# ---------------------------------------------------------------- divergence

def poison_params(handle, member: Optional[int] = None) -> None:
    """One-shot host poke: NaN the live params of an ``Experiment`` (or of
    ``Fleet`` member ``member``) between ``run()`` calls, in place. Raises
    if the handle has no state yet."""
    if hasattr(handle, "_fls"):                     # Fleet
        if handle._fls is None:
            raise RuntimeError("poison_params: fleet not initialized")
        if member is None:
            raise RuntimeError("poison_params: fleet poke needs member=")
        leaves = [x[member] for x in
                  tree_leaves(handle._fls.agent["params"])]
    else:                                           # Experiment
        if handle._ls is None:
            raise RuntimeError("poison_params: experiment not initialized")
        leaves = tree_leaves(handle._ls.agent["params"])
    with torch.no_grad():
        for x in leaves:
            if x.is_floating_point():
                x.fill_(float("nan"))


def arm_nan_step(trainer, at_step: int) -> None:
    """Persistent fault: NaN the params feeding the superstep whose agent
    update counter equals ``at_step`` (a device-side select, so it runs
    inside the captured graph too). Must be armed before the superstep is
    captured — it drops the trainer's graph to make sure."""
    inner = trainer.step

    def poisoned(ls, draws=None):
        fire = ls.agent["step"] == at_step
        params = tree_map(
            lambda x: (torch.where(fire, torch.full_like(x, float("nan")), x)
                       if x.is_floating_point() else x),
            ls.agent["params"])
        return inner(ls._replace(agent=dict(ls.agent, params=params)), draws)

    trainer.step = poisoned
    trainer.graph = None


# -------------------------------------------------------------- crash faults

def kill_now() -> None:
    """SIGKILL this process: no exception handling, no atexit, no flush."""
    os.kill(os.getpid(), signal.SIGKILL)


def arm_kill_mid_save(store) -> None:
    """SIGKILL at the worst checkpoint moment: everything staged and
    checksummed, one rename short of commit. The staging dir survives as
    garbage (``clean_staging`` removes it); the previous committed
    checkpoint must remain the restore target."""
    store._pre_commit_hook = lambda staging: kill_now()


class OneShotN:
    """In-process latch firing at most ``n`` times (thread-safe — the
    serving batcher trips it from its own thread)."""

    def __init__(self, n: int):
        self.n = n
        self.count = 0
        self._lock = threading.Lock()

    def fire(self) -> bool:
        with self._lock:
            if self.count >= self.n:
                return False
            self.count += 1
            return True


def arm_swap_fault(server, fires: int = 1) -> OneShotN:
    """Fault the serving engine's param hot-swap at its worst moment: new
    params fully staged, one pointer flip short of adoption. The first
    ``fires`` flips die mid-swap; the server must keep serving the OLD
    generation, and a re-push succeeds once the fault heals. Returns the
    latch (``latch.count`` = faults fired)."""
    latch = OneShotN(fires)

    def hook(generation: int) -> None:
        if latch.fire():
            raise RuntimeError(
                f"chaos: swap fault mid-flip (generation {generation})")

    server._pre_flip_hook = hook
    return latch


# --------------------------------------------------------- stored-state rot

def corrupt_checkpoint(path, mode: str = "bitflip",
                       filename: str = "state.npz") -> None:
    """Damage a COMMITTED checkpoint dir in place, leaving its manifest
    claiming health. ``bitflip`` inverts one byte mid-file (size preserved:
    only the checksum can tell); ``truncate`` drops the trailing half."""
    target = Path(path) / filename
    if not target.exists():
        raise FileNotFoundError(f"{target}: nothing to corrupt")
    size = target.stat().st_size
    if mode == "bitflip":
        with open(target, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    elif mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    else:
        raise ValueError(f"corrupt mode {mode!r}: bitflip|truncate")


# ------------------------------------------------------------ flaky sink IO

class FlakySink:
    """Wrap a metric sink so its first ``fails`` writes raise a transient
    ``OSError`` (then heal); ``fails=None`` fails forever (permanent).
    ``attempts`` counts every write() call, healthy or not."""

    def __init__(self, sink, fails: Optional[int] = 2):
        self.sink = sink
        self.fails = fails
        self.attempts = 0
        self.delivered = 0

    def write(self, rows: Sequence[dict]) -> None:
        self.attempts += 1
        if self.fails is None or self.attempts <= self.fails:
            raise OSError(f"chaos: transient sink IO error "
                          f"(attempt {self.attempts})")
        self.delivered += len(rows)
        self.sink.write(rows)

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        self.sink.close()
