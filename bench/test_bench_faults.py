"""A run whose timed path is broken underneath reads ``correct: false``:
each fault a cell can have, planted in the system at a small size on the
CPU (the run as ``bench/run.py`` makes it, but for the look for a card).
One chip has no exchange between chips to leave out."""
import numpy as np
import pytest
import torch

from bench import registry, testing

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def frozen(monkeypatch):
    """The update returns the state it was given."""
    from repro_torch.rl import sac
    real = sac.sac_update

    def update(state, cfg, batch, eps1, eps2):
        return state, real(state, cfg, batch, eps1, eps2)[1]
    monkeypatch.setattr(sac, "sac_update", update)


def half_batch(monkeypatch):
    """The update's losses over the batch's first half only."""
    from repro_torch.rl import sac
    real = sac.sac_update

    def update(state, cfg, batch, eps1, eps2):
        h = eps1.shape[0] // 2
        new, m = real(state, cfg, {k: v[:h] for k, v in batch.items()},
                      eps1[:h], eps2[:h])
        return new, dict(m, priorities=torch.cat([m["priorities"]] * 2))
    monkeypatch.setattr(sac, "sac_update", update)


def reward_altered(monkeypatch):
    """The first actor's reward off by 1 where the collect produces it."""
    from repro_torch.rl import apex
    real = apex.collect

    def collect(*a, **k):
        states, trs = real(*a, **k)
        first = torch.zeros_like(trs["rew"])
        first[0] = 1.0
        return states, dict(trs, rew=trs["rew"] + first)
    monkeypatch.setattr(apex, "collect", collect)


def row_shifted(monkeypatch):
    """Every sampled row one past the one its draw falls in."""
    from repro_torch.replay import device
    from repro_torch.rl.replay import SumTree
    real, real_host = device.sumtree_sample, SumTree.sample

    def sample(tree, targets, capacity):
        leaf, pri = real(tree, targets, capacity=capacity)
        return torch.clamp(leaf + 1, max=capacity - 1), pri

    def sample_host(self, targets):
        return np.minimum(real_host(self, targets) + 1, self.capacity - 1)
    monkeypatch.setattr(device, "sumtree_sample", sample)
    monkeypatch.setattr(SumTree, "sample", sample_host)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return testing.small_bench(tmp_path_factory.mktemp("bench") / "bench")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [frozen, half_batch, reward_altered,
                                   row_shifted])
def test_a_broken_timed_path_reads_incorrect(small, cell, fault,
                                             monkeypatch):
    fault(monkeypatch)
    got = testing.run_small(small, cell)
    assert not got["result"]["correct"], got["numbers"]
