"""The deep configuration, Fig. 4's corner (``sac-mlp2048x16``): its spec
as the preset makes it, its counts against hand-worked products, the
target networks' EMA counted against the system's target trees, the
readers of ``target_ms`` and ``target_roofline`` on a planted phase
table, and its small fleet (U=16, L=16, 2 members) against the plain
reference, the control failing."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import calibrate, count, registry, testing
from bench.count import targets

CONFIG, CELL = "sac-mlp2048x16", "sac-mlp2048x16.fleet5"
U, B = 2048, 256
# (K, N) of each product: obs 3 / obs + act 4 in, 15 square layers, the head
ACTOR = [(3, U)] + [(U, U)] * 15 + [(U, 2)]
CRITIC = [(4, U)] + [(U, U)] * 15 + [(U, 1)]


def _params(products):
    return sum(k * n + n for k, n in products)


def _flops(products, m):
    return sum(2 * m * k * n for k, n in products)


def test_the_spec_is_the_preset_at_the_grids_corner():
    from repro_torch.rl import presets
    config = registry.config(CONFIG)
    spec = presets.get(config["preset"]).override(
        **config["budget"], **config["overrides"])
    assert config["spec"] == json.loads(json.dumps(spec.to_dict()))
    net = config["spec"]["network"]
    assert (net["num_units"], net["num_layers"], net["connectivity"]) == \
        (2048, 16, "mlp")
    assert not config["spec"]["ofenet"]["enabled"]
    assert not config["spec"]["execution"]["distributed"]
    assert config["spec"]["eval"]["srank_every"] == 0
    assert config["reduced"] == []
    assert registry.workload(CELL)["members"] == 5


def test_params_a_net_by_hand():
    nets = count.nets(registry.config(CONFIG))
    assert nets["actor"].params() == _params(ACTOR) == 62_957_570
    assert nets["critic"].params() == _params(CRITIC) == 62_957_569
    assert [(k, n) for k, n, _ in nets["critic"].products()] == CRITIC


def test_update_flops_and_optimized_params_by_hand():
    config = registry.config(CONFIG)
    # no dx into a block's own input but where the actor's action needs it
    dx = lambda ps, m: _flops(ps[1:], m)
    f = lambda ps, m: _flops(ps, m)
    want = (f(ACTOR, 1)                                       # collect
            + 2 * f(CRITIC, B) + f(ACTOR, B)                  # target
            + 2 * (2 * f(CRITIC, B) + dx(CRITIC, B))          # critic loss
            + 2 * f(ACTOR, B) + dx(ACTOR, B)                  # actor loss
            + 2 * (2 * f(CRITIC, B))                          # its critics
            + f(CRITIC, B))                                   # priorities
    assert count.update_flops(config) == want == 547_811_774_464
    assert 14.9 < want / count.update_flops(registry.config("sac-mlp2048")) \
        < 15.1
    assert count.optimized_params(config) == \
        _params(ACTOR) + 2 * _params(CRITIC) + 1 == 188_872_709


def test_the_targets_ema_bytes_by_hand():
    config = registry.config(CONFIG)
    assert targets.elements(config) == 2 * _params(CRITIC) == 125_915_138
    # the target and the online net read, the target written, 5 members
    assert targets.ema_bytes(config, 5) == 12 * 125_915_138 * 5
    least_ms = 1e3 * targets.ema_bytes(config, 5) / count.HBM_BYTES_PER_S
    assert 2.25 < least_ms < 2.26
    dense = registry.config("sac-densenet2048")
    n = count.nets(dense)
    assert targets.elements(dense) == 2 * n["critic"].params() + sum(
        n[k].params() for k in ("phi_s", "phi_sa", "pred")) == 12_751_641


@pytest.mark.parametrize("name", ["sac-densenet2048", "sac-mlp2048",
                                  CONFIG])
def test_target_elements_are_the_systems_target_trees(name):
    from repro_torch.common import tree_leaves
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.experiment import ExperimentSpec
    from repro_torch.rl.policy import algo_config
    from repro_torch.rl.sac import sac_init
    spec = ExperimentSpec.from_dict(registry.config(name)["spec"]).override(
        num_units=16)
    config = {**registry.config(name), "spec": spec.to_dict()}
    acfg = algo_config(spec, make_env(spec.env))
    p = sac_init(acfg, torch.Generator().manual_seed(0), "cpu")["params"]
    trees = [p["target_critics"]] + (
        [p["ofenet"]["target"]] if "ofenet" in p else [])
    assert targets.elements(config) == sum(
        t.numel() for tree in trees for t in tree_leaves(tree))


def _ctx(table, members=5):
    ctx = SimpleNamespace(cell={"members": members},
                          config=registry.config(CONFIG))
    ctx.phase_table = table          # what bench.phases keeps on a ctx
    return ctx


def test_the_readers_on_a_planted_phase_table():
    ms_reader = registry.reader("layer_metrics", "target_ms")
    roof = registry.reader("layer_metrics", "target_roofline")
    table = {"update": 80.0, "target": 4.511}
    assert ms_reader.read(_ctx(table)) == 4.511
    least_ms = 1e3 * 12 * 125_915_138 * 5 / 3.35e12
    assert roof.read(_ctx(table)) == pytest.approx(100 * least_ms / 4.511)
    # a system without the target phase (an older one) or without stamps
    for got in ({"update": 80.0}, None):
        assert ms_reader.read(_ctx(got)) is None
        assert roof.read(_ctx(got)) is None


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return testing.small_bench(tmp_path_factory.mktemp("deep") / "bench")


def test_the_small_fleet_is_within_the_cells_limits(small):
    config = json.loads((small / "configs" / f"{CONFIG}.json").read_text())
    net = config["spec"]["network"]
    assert (net["num_units"], net["num_layers"]) == (16, 16)
    assert registry.workload(CELL, small)["members"] == 2
    got = testing.run_small(small, CELL, seed=3735928559)
    assert got["result"]["correct"] and got["result"]["failed"] == 0
    assert testing.with_limits(got, CELL), got["numbers"]
    assert got["result"]["attempted"] >= 2 * 2


def test_the_small_fleets_control_fails(small):
    got = calibrate.readings(CELL, [2654435761], ["control"],
                             torch.device("cpu"), small)
    limits = registry.workload(CELL)["limits"]
    nums = got["control"][0]
    assert any(nums[k] > v for k, v in limits.items()), nums
