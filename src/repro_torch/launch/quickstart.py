"""Quickstart: the paper's full technique on a small task, end to end, on
the port (counterpart of ``examples/quickstart.py``).

Trains a SAC agent with the three-fold method — (1) OFENet decoupled
representation, (2) wide MLP-DenseNet policy/value nets, (3) Ape-X-style
distributed collection — on the pendulum swing-up, and prints the
effective-rank trace showing the rank-collapse mitigation (paper §4).

Built on the experiment API: the ``quickstart`` preset plus ``--override
key=value`` tweaks (dotted spec paths or flat aliases), with optional
checkpoint/resume through the run handle. It runs on the card unless
``--device cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--steps 2000]
        [--override network.num_units=256] [--override replay.backend=device]
        [--override execution.mesh_shards=4] [--ckpt run.npz]
        [--resume run.npz] [--device cpu]

Diagnosing instability: pass ``--log-dir runs/a`` to stream per-step
telemetry (losses, grad norms, update ratios) into ``runs/a/metrics.jsonl``
without changing a single trained bit, then summarize with

    PYTHONPATH=src python -m repro_torch.obs.report runs/a

The report flags loss spikes (>10x the run median), non-finite values and
srank collapse. Add ``--trace 2`` to also capture a ``torch.profiler``
trace of the first two chunk dispatches under ``<log-dir>/trace``.

Guarding a run: ``--guard halt`` turns on in-loop health checks
(non-finite streams/params, spikes, srank collapse) that stop the run at
the offending step with a ``GuardViolation``; ``--guard skip`` instead
rewinds the current segment and re-runs it with a ``fold_in``-perturbed
generator. For unattended training — durable checkpoints, rollback
recovery, auto-resume after a crash — run under the supervisor instead:

    PYTHONPATH=src python -m repro_torch.guard.supervise quickstart \\
        --dir runs/q --retries 3

Serving the trained policy: pass ``--serve`` to finish the run with an
in-process round trip through the continuous-batching server: a
``PolicyServer`` coalesces concurrent requests into one forward a tick,
and the demuxed actions are checked against a direct
``act_deterministic`` call. The standalone server (with checkpoint
hot-swap from a durable checkpoint directory) is

    PYTHONPATH=src python -m repro_torch.launch.serve_policy quickstart \\
        --ckpt-dir runs/q/ckpts

Hacking on the loop itself? The port's contract (no clock or host RNG in
captured code, explicit generators, no hidden syncs, one graph a run) is
gated by ``repro_torch.check``:

    PYTHONPATH=src python -m repro_torch.check lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.check dynamic --preset smoke
"""
from __future__ import annotations

import argparse
import threading
from typing import List, Optional

import numpy as np

from repro_torch.rl import presets
from repro_torch.rl.experiment import Experiment, parse_overrides


def serve_round_trip(exp, n_clients: int = 4, per_client: int = 8) -> bool:
    """Serve the trained policy in-process: concurrent clients round-trip
    through the continuous-batching server, answers checked against a
    direct ``Policy.act_deterministic`` call. Returns whether they
    match."""
    from repro_torch.launch.serve_policy import PolicyServer, ServeConfig

    pol = exp.policy()
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((n_clients, per_client,
                               pol.obs_dim)).astype(np.float32)
    got = np.zeros((n_clients, per_client, pol.act_dim), np.float32)
    with PolicyServer(pol, ServeConfig(max_batch=8)) as server:
        def client(c):
            for i in range(per_client):
                got[c, i] = server.submit(obs[c, i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = dict(server.stats)
    direct = pol.act_deterministic(obs.reshape(-1, pol.obs_dim))
    ok = np.allclose(got.reshape(-1, pol.act_dim),
                     direct.cpu().numpy(), rtol=1e-5, atol=1e-6)
    print(f"served {stats['requests']} requests in {stats['ticks']} batched "
          f"ticks (sizes {dict(sorted(stats['batch_hist'].items()))}) — "
          f"{'match' if ok else 'MISMATCH vs'} direct policy call")
    print("standalone server: python -m repro_torch.launch.serve_policy "
          "<preset> --ckpt-dir <dir>")
    return ok


def build_spec(steps: int, units: Optional[int] = None,
               overrides: Optional[List[str]] = None, log_dir: str = "",
               trace: int = 0, guard: str = ""):
    """The quickstart's spec for these flags: the ``quickstart`` preset at
    ``units`` (default 128) and ``steps``, eval and srank 8 times a run,
    telemetry with ``log_dir``, the guard with ``guard``, then
    ``overrides`` (``KEY=VALUE``)."""
    obs = {}
    if log_dir:
        obs = {"obs.enabled": True, "obs.sinks": ("jsonl",),
               "obs.log_dir": log_dir, "obs.trace": trace,
               # ~100 train rows whatever the budget (cap at the ObsSpec
               # default cadence of 50)
               "obs.log_every": max(1, min(50, steps // 100))}
    guard_over = ({"guard.enabled": True, "guard.policy": guard}
                  if guard else {})
    return presets.get("quickstart").override(
        num_units=units or 128, total_steps=steps,
        eval_every=max(steps // 8, 1), srank_every=max(steps // 8, 1),
        **obs, **guard_over, **parse_overrides(overrides or []))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.quickstart")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--units", type=int, default=None,
                    help="network width (default 128; fresh runs only)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="spec override, e.g. network.num_layers=4 or "
                         "replay_backend=device (repeatable)")
    ap.add_argument("--ckpt", default="", help="save the run handle here")
    ap.add_argument("--resume", default="",
                    help="restore a --ckpt checkpoint and keep training")
    ap.add_argument("--log-dir", default="",
                    help="stream telemetry to <dir>/metrics.jsonl "
                         "(summarize: python -m repro_torch.obs.report "
                         "<dir>)")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="profile the first N chunk dispatches "
                         "into <log-dir>/trace (needs --log-dir)")
    ap.add_argument("--serve", action="store_true",
                    help="after training, serve the policy in-process and "
                         "round-trip concurrent requests through the "
                         "continuous-batching server")
    ap.add_argument("--guard", default="", choices=["", "halt", "skip"],
                    help="health guards: halt on divergence, or skip the "
                         "bad segment with a perturbed generator "
                         "(crash-safe rollback: python -m "
                         "repro_torch.guard.supervise)")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.resume:
        if args.override or args.units is not None or args.guard:
            ap.error("--override/--units/--guard cannot be combined with "
                     "--resume: the spec comes from the checkpoint metadata")
        exp = Experiment.restore(args.resume, device=args.device)
        print(f"resumed at step {exp.step} (spec from checkpoint metadata)")
    else:
        if args.trace and not args.log_dir:
            ap.error("--trace needs --log-dir (traces land in "
                     "<log-dir>/trace)")
        spec = build_spec(args.steps, args.units, args.override,
                          args.log_dir, args.trace, args.guard)
        exp = Experiment.from_spec(spec, device=args.device)

    res = exp.run(args.steps, progress=lambda s, r, m: print(
        f"step {s:6d}  eval return {r:9.1f}  "
        f"critic {m.get('critic_loss', 0):.3f}  aux {m.get('aux_loss', 0):.3f}"))
    print(f"\nparams={res.param_count:,}  max return={res.max_return:.1f}")
    print("effective-rank trace (srank of Q features):", res.sranks)
    if args.ckpt:
        exp.save(args.ckpt)
        print(f"checkpoint -> {args.ckpt}  (resume with --resume {args.ckpt})")
    ok = serve_round_trip(exp) if args.serve else True
    exp.close()
    if args.log_dir:
        print(f"telemetry -> {args.log_dir}/metrics.jsonl  "
              f"(summarize: python -m repro_torch.obs.report {args.log_dir})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
