"""Continuous-batching policy server with double-buffered hot-swap (port of
``repro/launch/serve_policy.py``; the checkpoint watcher and the CLI need
the durable store and come with the guard slice).

* **Bounded request queue.** ``submit(obs)`` blocks for the action;
  ``submit_async(obs)`` returns a ticket. A full queue blocks submitters.
* **Batcher.** One daemon thread coalesces up to ``max_batch`` requests,
  holding the first at most ``max_wait_ms`` for company, and pads the batch
  to a power-of-two slot (the set a CUDA graph per slot will capture).
* **One forward per tick.** The whole tick is ONE
  ``Policy.act_deterministic`` call on the padded batch; each client gets
  its row back.
* **Double-buffered hot-swap.** ``push_params`` stages new params (moved to
  the policy's device and materialized on the caller's thread); the
  batcher adopts them and bumps the generation BETWEEN ticks. Every
  response carries the generation whose params computed it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
# host-only server module: wall-clock latencies and batching deadlines are
# the point here, and nothing in this file is traced
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import tree_map


class ServerClosed(RuntimeError):
    """Submission after ``close()`` — the server no longer accepts work."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """``max_batch`` bounds a tick's batch; ``max_wait_ms`` how long the
    first request of a tick waits for company; ``queue_size`` admission
    (backpressure)."""
    max_batch: int = 32
    max_wait_ms: float = 2.0
    queue_size: int = 1024

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch={self.max_batch} must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms={self.max_wait_ms} must be >= 0")
        if self.queue_size < 1:
            raise ValueError(f"queue_size={self.queue_size} must be >= 1")

    @property
    def batch_slots(self) -> Tuple[int, ...]:
        """Padded batch shapes: powers of two up to ``max_batch`` (plus
        ``max_batch`` itself)."""
        slots = []
        s = 1
        while s < self.max_batch:
            slots.append(s)
            s *= 2
        slots.append(self.max_batch)
        return tuple(slots)

    def slot_for(self, n: int) -> int:
        for s in self.batch_slots:
            if n <= s:
                return s
        raise ValueError(f"batch of {n} exceeds max_batch={self.max_batch}")


class _Ticket:
    """One in-flight request, fulfilled with its action row and the
    generation of the params that computed it."""

    __slots__ = ("obs", "t_submit", "_done", "action", "generation",
                 "error")

    def __init__(self, obs: np.ndarray):
        self.obs = obs
        self.t_submit = time.monotonic()
        self._done = threading.Event()
        self.action: Optional[np.ndarray] = None
        self.generation: Optional[int] = None
        self.error: Optional[BaseException] = None

    def _fulfill(self, action: np.ndarray, generation: int) -> None:
        self.action = action
        self.generation = generation
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("policy request not served in time")
        if self.error is not None:
            raise self.error
        return self.action


class PolicyServer:
    """Serve ``policy.act_deterministic`` to concurrent clients as a
    continuous-batching loop with generation-stamped hot-swap.

    >>> server = PolicyServer(Policy.from_checkpoint("run.npz")).start()
    >>> action = server.submit(obs)              # thread-safe, blocking
    >>> server.push_params(new_params)           # flips between ticks
    >>> server.close()                           # drains, then stops
    """

    def __init__(self, policy, config: ServeConfig = ServeConfig()):
        if policy.params is None:
            raise ValueError("PolicyServer needs a params-bound Policy "
                             "(from_checkpoint / with_params)")
        self.config = config
        self._policy = policy
        self._generation = 0
        self._queue: "queue.Queue[_Ticket]" = queue.Queue(config.queue_size)
        self._swap_lock = threading.Lock()
        self._staged: Optional[tuple] = None      # (params, meta) shadow
        self._closing = False
        self._batcher: Optional[threading.Thread] = None
        # test seam: called with the incoming generation right before the
        # flip; raising ABORTS the swap (old generation keeps serving)
        self._pre_flip_hook: Optional[Callable[[int], None]] = None
        self.stats: Dict[str, Any] = {
            "requests": 0, "ticks": 0, "swaps": 0, "swap_aborts": 0,
            "batch_hist": {}, "latencies_ms": [],
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "PolicyServer":
        if self._batcher is not None:
            raise RuntimeError("server already started")
        self._batcher = threading.Thread(target=self._serve_loop,
                                         name="serve-batcher", daemon=True)
        self._batcher.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the server. ``drain=True`` serves every admitted request
        first; ``drain=False`` fails pending requests with
        ``ServerClosed``."""
        self._closing = True                # stop admitting first
        if not drain:
            while True:
                try:
                    self._queue.get_nowait()._fail(
                        ServerClosed("server closed without drain"))
                except queue.Empty:
                    break
        if self._batcher is not None:
            self._batcher.join()
            self._batcher = None

    def __enter__(self) -> "PolicyServer":
        return self.start() if self._batcher is None else self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ submitting
    def submit_async(self, obs) -> _Ticket:
        """Enqueue one observation; the ticket's ``result()`` blocks for
        the action. Blocks only when the bounded queue is full."""
        if self._closing:
            raise ServerClosed("server is closed")
        ob = np.asarray(obs, dtype=np.float32)
        if ob.shape != (self.obs_dim,):
            raise ValueError(f"obs shape {ob.shape} != ({self.obs_dim},) — "
                             f"submit one observation per request")
        t = _Ticket(ob)
        self._queue.put(t)
        return t

    def submit(self, obs, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: one observation in, one action out."""
        return self.submit_async(obs).result(timeout)

    @property
    def obs_dim(self) -> int:
        return self._policy.obs_dim

    @property
    def generation(self) -> int:
        return self._generation

    # ------------------------------------------------------------- hot-swap
    def push_params(self, params, meta: Optional[dict] = None) -> None:
        """Stage new params for the NEXT tick. The caller's thread pays the
        transfer to the policy's device; the batcher only flips a pointer.
        The newest staged params win."""
        dev = self._policy.device
        params = tree_map(lambda t: t.to(dev), params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with self._swap_lock:
            self._staged = (params, meta or {})

    def _maybe_flip(self) -> None:
        """Adopt staged params between ticks (batcher thread only), so the
        (generation, policy) a tick reads is always a consistent pair."""
        with self._swap_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        params, _meta = staged
        if self._pre_flip_hook is not None:
            try:
                self._pre_flip_hook(self._generation + 1)
            except Exception:
                # a failed flip leaves the OLD generation serving
                self.stats["swap_aborts"] += 1
                return
        self._policy = self._policy.with_params(params)
        self._generation += 1
        self.stats["swaps"] += 1

    # -------------------------------------------------------------- batcher
    def _coalesce(self) -> List[_Ticket]:
        """Up to ``max_batch`` requests: block for the first, then hold the
        tick open ``max_wait_ms`` for stragglers. [] when idle."""
        cfg = self.config
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + cfg.max_wait_ms / 1000.0
        while len(batch) < cfg.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _serve_loop(self) -> None:
        while True:
            batch = self._coalesce()
            if not batch:
                if self._closing and self._queue.empty():
                    return                       # graceful drain complete
                self._maybe_flip()               # idle servers upgrade too
                continue
            self._maybe_flip()                   # swaps land BETWEEN ticks
            gen, policy = self._generation, self._policy
            try:
                slot = self.config.slot_for(len(batch))
                obs = np.zeros((slot, self.obs_dim), dtype=np.float32)
                for i, t in enumerate(batch):
                    obs[i] = t.obs
                # ONE forward for the whole tick; padded rows are dropped
                acts = policy.act_deterministic(obs).cpu().numpy()
                now = time.monotonic()
                for i, t in enumerate(batch):
                    self.stats["latencies_ms"].append(
                        (now - t.t_submit) * 1e3)
                    t._fulfill(acts[i], gen)
                self.stats["requests"] += len(batch)
                self.stats["ticks"] += 1
                h = self.stats["batch_hist"]
                h[len(batch)] = h.get(len(batch), 0) + 1
            except Exception as err:
                # the batcher must keep serving: the tick's clients get
                # the error, later ticks run as usual
                for t in batch:
                    t._fail(err)
