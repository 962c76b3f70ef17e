"""The port's continuous-batching policy server (ported from
``tests/test_serve.py``, minus the checkpoint watcher).

Responses equal a direct ``Policy.act_deterministic`` call; a burst
coalesces into batched ticks padded to the slot set; a hot-swap lands
atomically between ticks (every response consistent with its stamped
generation, zero drops), also when the flip faults; ``close()`` drains or
fails pending requests. The policy runs on the CPU here (plain stack); the
server is the same on the card.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.common import tree_map
from repro_torch.launch.serve_policy import (PolicyServer, ServeConfig,
                                             ServerClosed)
from repro_torch.rl import sac as sac_mod
from repro_torch.rl.envs import make_env
from repro_torch.rl.experiment import ExperimentSpec
from repro_torch.rl.policy import Policy, algo_config

_BASE = dict(env="pendulum", algo="sac", num_units=16, num_layers=1,
             use_ofenet=True, ofenet_units=8, ofenet_layers=2,
             block_backend="fused")
TOL = dict(rtol=1e-5, atol=1e-6)


def _policy(seed=7):
    spec = ExperimentSpec().override(**_BASE)
    acfg = algo_config(spec, make_env(spec.env))
    params = sac_mod.sac_init(acfg, torch.Generator().manual_seed(seed),
                              device="cpu")["params"]
    params = tree_map(lambda t: t + 0.05, params)     # non-zero biases
    return Policy.from_spec(spec, params, device="cpu")


def _obs_batch(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim)).astype(np.float32)


def _direct(pol, obs):
    return pol.act_deterministic(obs).numpy()


def _join(threads):
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "client thread hung"


def test_responses_match_direct_policy():
    pol = _policy()
    obs = _obs_batch(48, pol.obs_dim)
    direct = _direct(pol, obs)
    out = np.zeros((48, pol.act_dim), np.float32)

    with PolicyServer(pol, ServeConfig(max_batch=8)) as server:
        def client(lo, hi):
            for i in range(lo, hi):
                out[i] = server.submit(obs[i], timeout=30.0)

        threads = [threading.Thread(target=client, args=(j * 12, (j + 1) * 12))
                   for j in range(4)]
        for t in threads:
            t.start()
        _join(threads)
    np.testing.assert_allclose(out, direct, **TOL)
    assert server.stats["requests"] == 48
    assert server.stats["latencies_ms"], "latency accounting missing"


def test_bad_obs_shape_rejected():
    pol = _policy()
    server = PolicyServer(pol).start()
    try:
        with pytest.raises(ValueError, match="obs shape"):
            server.submit_async(np.zeros((2, pol.obs_dim), np.float32))
    finally:
        server.close()


def test_unbound_policy_rejected():
    with pytest.raises(ValueError, match="params-bound"):
        PolicyServer(_policy().with_params(None))


def test_serve_config_validates_and_lists_slots():
    cfg = ServeConfig(max_batch=8)
    assert cfg.batch_slots == (1, 2, 4, 8)
    assert cfg.slot_for(3) == 4 and cfg.slot_for(8) == 8
    assert ServeConfig(max_batch=12).batch_slots == (1, 2, 4, 8, 12)
    with pytest.raises(ValueError):
        cfg.slot_for(9)
    for bad in (dict(max_batch=0), dict(max_wait_ms=-1), dict(queue_size=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_burst_coalesces_into_padded_slot_ticks():
    """Requests queued before the batcher starts are served in max_batch
    ticks, and every forward runs on a padded batch slot."""
    pol = _policy()
    shapes = []

    class Spy(Policy):
        def act_deterministic(self, obs):
            shapes.append(np.shape(obs)[0])
            return super().act_deterministic(obs)

    spy = Spy(pol._core, pol.params, pol.device)
    cfg = ServeConfig(max_batch=8, max_wait_ms=50.0)
    server = PolicyServer(spy, cfg)
    obs = _obs_batch(19, pol.obs_dim)
    tickets = [server.submit_async(o) for o in obs]   # queued pre-start
    server.start()
    got = np.stack([t.result(timeout=30.0) for t in tickets])
    server.close()
    assert server.stats["requests"] == 19
    assert server.stats["batch_hist"] == {8: 2, 3: 1}, \
        server.stats["batch_hist"]
    assert shapes == [8, 8, 4]
    np.testing.assert_allclose(got, _direct(pol, obs), **TOL)


def _gen_policies(pol):
    """Two visibly different parameter generations."""
    return {0: pol, 1: pol.with_params(tree_map(lambda t: t + 0.25,
                                                pol.params))}


def test_hot_swap_atomic_no_mixed_generations():
    """Swap mid-traffic: every response equals the direct computation under
    the generation STAMPED ON IT, and nothing is dropped."""
    pol = _policy()
    gens = _gen_policies(pol)
    obs = _obs_batch(96, pol.obs_dim)
    results = [None] * 96
    server = PolicyServer(pol, ServeConfig(max_batch=8)).start()

    def client(lo, hi):
        for i in range(lo, hi):
            t = server.submit_async(obs[i])
            results[i] = (t.result(timeout=30.0), t)

    threads = [threading.Thread(target=client, args=(j * 24, (j + 1) * 24))
               for j in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.01)
    server.push_params(gens[1].params)            # swap under live traffic
    _join(threads)
    server.close()

    assert server.generation == 1 and server.stats["swaps"] == 1
    want = {g: _direct(p, obs) for g, p in gens.items()}
    for i, (action, ticket) in enumerate(results):
        assert action is not None, f"request {i} dropped"
        np.testing.assert_allclose(
            action, want[ticket.generation][i], **TOL,
            err_msg=f"request {i} inconsistent with its generation")


def test_swap_fault_keeps_old_generation_serving():
    """A flip that faults with the params fully staged leaves the OLD
    generation serving (zero drops), counts the abort, and a later push
    succeeds once the fault heals."""
    pol = _policy()
    gens = _gen_policies(pol)
    obs = _obs_batch(8, pol.obs_dim)
    server = PolicyServer(pol, ServeConfig(max_batch=4)).start()
    fired = []

    def hook(generation):
        if not fired:
            fired.append(generation)
            raise RuntimeError(f"swap fault mid-flip (generation "
                               f"{generation})")

    server._pre_flip_hook = hook
    server.push_params(gens[1].params)
    a = np.stack([server.submit(o, timeout=30.0) for o in obs])
    assert fired == [1] and server.stats["swap_aborts"] == 1
    assert server.generation == 0, "aborted swap must not bump generation"
    np.testing.assert_allclose(a, _direct(gens[0], obs), **TOL)

    server.push_params(gens[1].params)            # fault healed
    b = np.stack([server.submit(o, timeout=30.0) for o in obs])
    server.close()
    assert server.generation == 1 and server.stats["swaps"] == 1
    np.testing.assert_allclose(b, _direct(gens[1], obs), **TOL)


def test_tick_error_fails_only_that_tick():
    """A forward that raises fails its own tick's clients; the batcher
    keeps serving later ticks."""
    pol = _policy()
    server = PolicyServer(pol, ServeConfig(max_batch=4, max_wait_ms=0.0))
    actor = pol.params["actor"]
    broken = {**actor, "out": {**actor["out"], "w": actor["out"]["w"][:1]}}
    server._policy = pol.with_params({**pol.params, "actor": broken})
    server.start()
    with pytest.raises(RuntimeError):
        server.submit(np.zeros(pol.obs_dim, np.float32), timeout=30.0)
    server.push_params(pol.params)
    ok = server.submit(np.zeros(pol.obs_dim, np.float32), timeout=30.0)
    server.close()
    np.testing.assert_allclose(ok, _direct(pol, np.zeros(pol.obs_dim,
                                                          np.float32)), **TOL)


def test_close_drains_pending_requests():
    pol = _policy()
    server = PolicyServer(pol, ServeConfig(max_batch=4, max_wait_ms=0.0))
    tickets = [server.submit_async(o)
               for o in _obs_batch(32, pol.obs_dim)]
    server.start()
    server.close()                                # must serve all 32 first
    for t in tickets:
        assert t.result(timeout=0) is not None
    assert server.stats["requests"] == 32
    with pytest.raises(ServerClosed):
        server.submit(np.zeros(pol.obs_dim, np.float32))


def test_close_without_drain_fails_pending():
    pol = _policy()
    server = PolicyServer(pol)                    # batcher never started
    tickets = [server.submit_async(o)
               for o in _obs_batch(4, pol.obs_dim)]
    server.close(drain=False)
    for t in tickets:
        with pytest.raises(ServerClosed):
            t.result(timeout=1.0)


def test_probe_serve_load_answers_every_request_per_round():
    """``launch/probe.py``'s closed-loop load (the serving numbers two
    checkouts are compared by on the card): each round answers all its
    requests, in ticks of at most ``max_batch``, and reports its rate and
    latency percentiles from the clients' clocks."""
    from repro_torch.launch import probe
    rows = probe.serve_load(_policy(), rounds=2, requests=24, clients=3)
    assert len(rows) == 2
    for r in rows:
        assert r["req_s"] > 0 and 0 < r["p50_ms"] <= r["p99_ms"]
        assert 24 // ServeConfig().max_batch <= r["ticks"] <= 24
