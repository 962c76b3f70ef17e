"""Continuous-batching policy server with double-buffered hot-swap and a
checkpoint watcher (port of ``repro/launch/serve_policy.py``).

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
* **Checkpoint watcher.** ``server.watch(store)`` polls a
  ``repro_torch.guard.DurableStore`` for new checkpoints, takes only ones
  that VERIFY (``store.verify``: torn or bit-flipped checkpoints are
  skipped and reported through ``on_bad``), restores their
  ``agent/params`` subtree through ``rl.policy.load_params`` and pushes
  it. A live learner (or ``repro_torch.guard.supervise``) committing
  checkpoints into the store upgrades the server without pausing it.

CLI::

    python -m repro_torch.launch.serve_policy <preset> --ckpt-dir runs/x/ckpts

serves the newest verified checkpoint in the store (``--train N`` first
trains the preset for N steps and commits a checkpoint, so the command is
self-contained), watches the store for more, fires a synthetic concurrent
client load and prints latency/throughput stats. It runs on the CUDA card
unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
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
    (backpressure); ``poll_s`` the checkpoint watcher's store-poll
    cadence."""
    max_batch: int = 32
    max_wait_ms: float = 2.0
    queue_size: int = 1024
    poll_s: float = 0.25

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
        self._watcher: Optional[threading.Thread] = None
        self._watch_stop = threading.Event()
        # test seam: called with the incoming generation right before the
        # flip; raising ABORTS the swap (old generation keeps serving)
        self._pre_flip_hook: Optional[Callable[[int], None]] = None
        self.stats: Dict[str, Any] = {
            "requests": 0, "ticks": 0, "swaps": 0, "swap_aborts": 0,
            "bad_checkpoints": 0, "batch_hist": {}, "latencies_ms": [],
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
        self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join()
            self._watcher = None
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

    # -------------------------------------------------------------- watcher
    def watch(self, store, spec=None, seen_step: int = -1,
              on_bad: Optional[Callable] = None) -> "PolicyServer":
        """Poll ``store`` (a ``repro_torch.guard.DurableStore``) and
        hot-swap onto each NEW checkpoint that verifies. Corrupt or torn
        checkpoints are counted, reported through ``on_bad`` and skipped —
        the server keeps serving the last good generation. ``seen_step``:
        the checkpoint step already being served."""
        if self._watcher is not None:
            raise RuntimeError("watcher already running")
        from repro_torch.rl.policy import load_params
        dev = self._policy.device

        def loop():
            seen = seen_step
            while not self._watch_stop.is_set():
                path = None
                try:
                    cks = store.checkpoints()
                    if cks and store.step_of(cks[-1]) > seen:
                        path = cks[-1]
                        store.verify(path)
                except Exception as bad:
                    if path is not None:
                        seen = store.step_of(path)   # don't re-verify it
                        self.stats["bad_checkpoints"] += 1
                        if on_bad is not None:
                            on_bad(bad)
                    path = None
                if path is not None:
                    step = store.step_of(path)
                    _, params = load_params(store.payload(path), spec,
                                            device=dev)
                    self.push_params(params, {"step": step})
                    seen = step
                self._watch_stop.wait(self.config.poll_s)

        self._watcher = threading.Thread(target=loop, name="serve-watcher",
                                         daemon=True)
        self._watcher.start()
        return self

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


# ------------------------------------------------------------------- CLI

def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_policy",
        description="Serve a trained policy with continuous batching and "
                    "checkpoint hot-swap, then drive a synthetic client "
                    "load against it.")
    p.add_argument("preset", help="preset name (repro_torch.rl.presets)")
    p.add_argument("--ckpt-dir", required=True,
                   help="DurableStore directory to serve from (and watch)")
    p.add_argument("--train", type=int, default=0, metavar="STEPS",
                   help="train the preset this many steps and commit a "
                        "checkpoint first (self-contained demo)")
    p.add_argument("--override", action="append", default=[],
                   metavar="K=V", help="spec override for --train "
                                       "(repeatable)")
    p.add_argument("--requests", type=int, default=256,
                   help="synthetic client requests to fire")
    p.add_argument("--clients", type=int, default=8,
                   help="concurrent client threads")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--device", default=None,
                   help="serving (and --train) device (default: the card)")
    args = p.parse_args(argv)

    from repro_torch.guard import DurableStore
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import parse_overrides
    from repro_torch.rl.policy import Policy, load_params

    spec = presets.get(args.preset)
    if args.override:
        spec = spec.override(**parse_overrides(args.override))
    store = DurableStore(args.ckpt_dir)

    if args.train:
        from repro_torch.rl.experiment import Experiment
        exp = Experiment.from_spec(spec, device=args.device)
        exp.run(args.train)
        store.save(exp.save, step=args.train)
        exp.close()
        print(f"trained {args.train} steps -> committed checkpoint "
              f"step-{args.train}")

    good = store.restore_latest(on_bad=lambda bad: print(f"skipping {bad}"))
    if good is None:
        print(f"no verified checkpoint under {args.ckpt_dir} "
              f"(hint: --train N)")
        return 2
    spec_ck, params = load_params(store.payload(good), device=args.device)
    policy = Policy.from_spec(spec_ck, params, device=args.device)
    cfg = ServeConfig(max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms)
    server = PolicyServer(policy, cfg).start().watch(
        store, spec_ck, seen_step=store.step_of(good))
    print(f"serving {spec_ck.algo}/{spec_ck.env} from {good.name} on "
          f"{policy.device} (slots {cfg.batch_slots})")

    rng = np.random.default_rng(0)
    all_obs = rng.standard_normal(
        (args.requests, policy.obs_dim)).astype(np.float32)
    idx = iter(range(args.requests))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            server.submit(all_obs[i], timeout=30.0)

    t0 = time.monotonic()
    threads = [threading.Thread(target=client)
               for _ in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    server.close()

    lat = server.stats["latencies_ms"]
    print(f"{args.requests} requests / {args.clients} clients in "
          f"{wall:.3f}s -> {args.requests / wall:.0f} req/s")
    print(f"latency ms: p50={_percentile(lat, 50):.2f} "
          f"p99={_percentile(lat, 99):.2f}")
    print(f"ticks={server.stats['ticks']} "
          f"batch_hist={dict(sorted(server.stats['batch_hist'].items()))} "
          f"generation={server.generation} swaps={server.stats['swaps']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
