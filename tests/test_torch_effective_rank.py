"""The port's effective rank against the JAX reference.

``effective_rank`` and ``srank_curve`` of ``repro_torch.core`` against
``repro.core.effective_rank`` on the same seeded numpy features: tall,
wide, rank-deficient and 3-d (reshaped to ``(-1, dim)``) inputs at several
deltas, with exact integer equality. The two SVDs round differently, so
the features are built so that no cumulative share of singular values
lies within 1e-4 of ``1 - delta``: each case checks that premise in
float64 before it compares.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.effective_rank import effective_rank, srank_curve

DELTAS = (0.3, 0.1, 0.05, 0.01)
MARGIN = 1e-4


def _features(seed, shape, rank=None, decay=0.8):
    """Seeded features ``U diag(s) V^T`` with singular values ``s`` decaying
    geometrically (zero past ``rank``), reshaped to ``shape``."""
    rng = np.random.default_rng(seed)
    rows, dim = int(np.prod(shape[:-1])), shape[-1]
    k = min(rows, dim)
    u, _ = np.linalg.qr(rng.standard_normal((rows, k)))
    v, _ = np.linalg.qr(rng.standard_normal((dim, k)))
    s = 3.0 * decay ** np.arange(k)
    if rank is not None:
        s[rank:] = 0.0
    return ((u * s) @ v.T).astype(np.float32).reshape(shape)


def _check_margin(x, deltas):
    s = np.linalg.svd(x.reshape(-1, x.shape[-1]).astype(np.float64),
                      compute_uv=False)
    cum = np.cumsum(s) / s.sum()
    for d in deltas:
        assert np.min(np.abs(cum - (1 - d))) > MARGIN, (d, cum)


CASES = {"tall": dict(seed=0, shape=(256, 32)),
         "wide": dict(seed=1, shape=(8, 40), decay=0.6),
         "square": dict(seed=2, shape=(24, 24), decay=0.9),
         "rank-deficient": dict(seed=3, shape=(64, 16), rank=5, decay=0.95),
         "3-d": dict(seed=4, shape=(4, 16, 12), decay=0.7)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("delta", DELTAS)
def test_effective_rank_matches_jax(case, delta):
    from repro.core.effective_rank import effective_rank as jrank
    x = _features(**CASES[case])
    _check_margin(x, (delta,))
    got = effective_rank(torch.from_numpy(x), delta)
    assert got.dtype == torch.int32 and got.ndim == 0
    assert int(got) == int(jrank(x, delta))


@pytest.mark.parametrize("case", sorted(CASES))
def test_srank_curve_matches_jax(case):
    from repro.core.effective_rank import srank_curve as jcurve
    x = _features(**CASES[case])
    _check_margin(x, (0.1, 0.05, 0.01))
    assert srank_curve(torch.from_numpy(x)) == jcurve(x)


def test_effective_rank_of_a_rank_r_matrix_is_at_most_r():
    x = _features(seed=5, shape=(50, 20), rank=3, decay=1.0)
    _check_margin(x, (0.01,))
    assert int(effective_rank(torch.from_numpy(x), 0.01)) == 3
    assert int(effective_rank(torch.zeros((6, 4)))) == 1
