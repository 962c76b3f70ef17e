"""The start both sides run from: made by the reference from the seed
alone, and held by the system, leaf for leaf, once handed to it."""
import math

import numpy as np
import pytest
import torch

from bench import drive, registry, testing
from bench.reference import sac_ref as ref

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SEED = 3221225509


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return testing.small_bench(tmp_path_factory.mktemp("bench") / "bench")


def _files(small, cell):
    spec = registry.workload(cell, small)
    config = registry.config(spec["config"], small)
    return spec, config, ref.RefConfig.from_files(config, spec)


def _host(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("cell", CELLS)
def test_the_start_comes_from_the_seed_alone(small, cell):
    _, _, rcfg = _files(small, cell)
    a, b = (ref.init_starts(rcfg, [SEED, SEED + 1], "cpu") for _ in "ab")
    for x, y in zip(a, b):
        for kind in ("params", "opt", "store", "env"):
            for k in x[kind]:
                assert torch.equal(x[kind][k], y[kind][k]), (kind, k)
        assert torch.equal(x["gen_state"], y["gen_state"])
    w = "params/actor/layers/0/dense/w"
    assert not torch.equal(a[0]["params"][w], a[1]["params"][w])
    assert not torch.equal(a[0]["store"]["act"], a[1]["store"]["act"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_start_is_a_fresh_run(small, cell):
    """Fan-in uniform weights, zero biases, targets equal to their nets,
    AdamW at zero, and every warm-up row a pendulum step of its
    observation under an action in [-1, 1)."""
    _, _, rcfg = _files(small, cell)
    S0 = ref.init_starts(rcfg, [SEED], "cpu")[0]
    P = S0["params"]
    for path, fan_in, fan_out in ref.dense_layers(rcfg):
        w = P[f"{path}/w"]
        assert w.shape == (fan_in, fan_out)
        bound = 1.0 / math.sqrt(fan_in)
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > bound * max(0.5, 1 - 10 / w.numel())
        assert abs(float(w.mean())) < 5 * bound / math.sqrt(3 * w.numel())
        assert not P[f"{path}/b"].any()
    for p, v in P.items():
        for tgt, online in (("/target_critics/", "/critics/"),
                            ("/ofenet/target/", "/ofenet/online/")):
            if tgt in p:
                assert torch.equal(v, P[p.replace(tgt, online)])
    assert float(P["params/log_alpha"]) == pytest.approx(
        math.log(rcfg.init_alpha))
    assert all(not v.any() for v in S0["opt"].values())
    st, n = S0["store"], S0["count"]
    assert n == max(rcfg.warmup_steps // rcfg.n_actors, 1) * rcfg.n_actors
    th = torch.atan2(st["obs"][:, 1], st["obs"][:, 0])[:, None]
    q, qd, rew = ref.pendulum_step(th, st["obs"][:, 2:3] * ref.MAX_SPEED,
                                   st["act"])
    np.testing.assert_allclose(_host(ref.pendulum_obs(q, qd)),
                               _host(st["next_obs"]), atol=1e-5)
    np.testing.assert_allclose(_host(rew), _host(st["rew"]), atol=1e-4)
    assert float(st["act"].min()) >= -1.0 and float(st["act"].max()) < 1.0
    assert not st["done"].any()


@pytest.mark.parametrize("cell", CELLS)
def test_the_system_holds_the_start_it_was_handed(small, cell):
    spec, config, rcfg = _files(small, cell)
    drv = drive.make(config, spec, SEED, torch.device("cpu"))
    starts = ref.init_starts(rcfg, drv.seeds, "cpu")
    drv.load(starts)
    ls = drv.state()
    for m, S0 in enumerate(starts):
        at = (lambda t: t[m]) if drv._stacked else (lambda t: t)
        for kind in ("params", "opt"):
            have = dict(drive.flatten(ls.agent[kind], kind))
            assert set(have) == set(S0[kind])
            for p, v in have.items():
                assert torch.equal(at(v), S0[kind][p]), p
        for f, v in S0["env"].items():
            assert torch.equal(at(getattr(ls.actors, f)), v), f
        gen = ls.gen[m] if drv._stacked else ls.gen
        assert torch.equal(gen.get_state(), S0["gen_state"])
        n = S0["count"]
        tr = drv.trainer
        if tr.host:
            inner = getattr(tr.buffer, "_inner", tr.buffer)
            data, count = inner.data, inner.count
            assert tr.rng.bit_generator.state == S0["rng_state"]
        else:
            store = ls.replay["store"]
            data = {k: _host(at(v)) for k, v in store["data"].items()}
            count = int(at(store["count"]))
        assert count == n
        for k, v in S0["store"].items():
            np.testing.assert_array_equal(
                np.asarray(data[k][:n]).reshape(n, -1),
                _host(v).reshape(n, -1), err_msg=k)


@pytest.mark.parametrize("cell", CELLS)
def test_a_system_on_its_own_weights_reads_incorrect(small, cell,
                                                     monkeypatch):
    """The reference's start is its own: a system that kept the weights of
    its own init instead of those handed to it fails the comparison."""
    real = drive.Driver._put

    def put(self, ls, start):
        own = {p: v.clone() for p, v in drive.flatten(ls.agent["params"],
                                                      "params")}
        real(self, ls, dict(start, params=own))
    monkeypatch.setattr(drive.Driver, "_put", put)
    got = testing.run_small(small, cell)
    assert not got["result"]["correct"], got["numbers"]
