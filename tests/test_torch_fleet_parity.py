"""The fleet-vs-solo flip analysis (``repro_torch.launch.fleet_parity``)
on the CPU: the rebuilt sample of a superstep against the superstep's own,
and the boundary measure on trees of known leaves. ``hold_members`` reads
the captured graphs' batches and runs on the card only
(``chip_smoke.py``'s fused fig3 fleet)."""
import pytest
import torch

from repro_torch.launch import fleet_parity as fp


@pytest.fixture(scope="module")
def trained():
    from repro_torch.rl.experiment import Experiment, ExperimentSpec
    spec = ExperimentSpec().override(
        num_units=16, ofenet_units=8, ofenet_layers=2, n_core=1, n_env=4,
        warmup_steps=8, eval_every=100, eval_episodes=1,
        replay_capacity=64, batch_size=16, replay_backend="device",
        block_backend="fused")
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(5)
    return exp


def test_rebuilt_sample_is_the_supersteps_own(trained):
    """From a copy of the state before a superstep, the draws, collect and
    add rebuild the tree it sampled: the same leaves and bitwise the same
    IS weights as the superstep itself; two copies of one state flip no
    row, so no cause is shown."""
    from repro_torch.rl.runner import clone_state
    tr = trained.trainer
    pre = clone_state(trained._ls)
    _, _, batch = tr.step(clone_state(pre))
    tree, u, idx, w = fp._sample_time(tr, pre)
    assert torch.equal(w, batch["weight"])
    assert u.shape == (tr.batch_size,) and idx.shape == (tr.batch_size,)
    rec = fp.flip_cause(tr, pre, pre, [], batch["weight"], batch["weight"])
    assert rec["same_draws"] and rec["weights_err"] == 0.0
    assert rec["rebuilt_rows"] == [] and rec["leaves_rel"] == 0.0
    assert not rec["shown"]


def test_flip_cause_refuses_a_moved_boundary(trained):
    """A leaf halved in the solo tree moves the boundaries by far more than
    float32 rounding: the rows it flips are found (each draw between its
    two boundaries) and the cause is not shown."""
    from repro_torch.kernels.replay_tree.ops import sumtree_get, sumtree_set
    from repro_torch.rl.runner import clone_state
    tr = trained.trainer
    pre = clone_state(trained._ls)
    _, _, ia, wa = fp._sample_time(tr, pre)
    pre_b = clone_state(pre)
    j = ia[3:4]
    sumtree_set(pre_b.replay["tree"], j,
                sumtree_get(pre_b.replay["tree"], j) * 0.5)
    _, _, ib, wb = fp._sample_time(tr, pre_b)
    rows = (ia != ib).nonzero().flatten().tolist()
    assert rows
    rec = fp.flip_cause(tr, pre, pre_b, rows, wa, wb)
    assert rec["rebuilt_rows"] == rows and rec["weights_err"] == 0.0
    for d in rec["draws"]:
        assert min(d["member"], d["solo"]) <= d["r"] <= max(d["member"],
                                                             d["solo"])
        assert d["dist"] > rec["tol"]
    assert not rec["shown"]


@pytest.mark.parametrize("u,leaves,dist,between", [
    # the draw on the boundary between leaves 1 and 2 (3 of 10), which
    # leaf 1's priority 1e-7 higher moves by ~1.4e-8 in the other tree
    (0.3, (1, 2), 1.4e-8, False),
    # a draw 0.05 from it
    (0.35, (1, 2), 0.05, False),
    # leaves 0 and 2: the same boundary, but leaf 1 between them holds
    # priority
    (0.3, (0, 2), 1.4e-8, True)])
def test_draws_at_boundaries(u, leaves, dist, between):
    """The boundary measure on trees of known leaves: one stratum, the
    row's two leaves, the draw's distance from the boundary between them
    in both trees and whether a leaf with priority lies between."""
    la = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    lb = la.clone()
    lb[1] += 2e-7
    got = fp.draws_at_boundaries(la, lb, torch.tensor([leaves[0]]),
                                 torch.tensor([leaves[1]]),
                                 torch.tensor([u], dtype=torch.float64), 1)
    assert len(got) == 1 and got[0]["row"] == 0
    assert got[0]["leaves"] == leaves and got[0]["between"] == between
    assert got[0]["dist"] == pytest.approx(dist, rel=0.05, abs=1e-9)
    assert fp.draws_at_boundaries(la, lb, torch.tensor([2]),
                                  torch.tensor([2]), torch.tensor([u]),
                                  1) == []
