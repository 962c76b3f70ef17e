"""The plain reference against the system's CPU path at a small size: a
sound run of each cell is correct under the cell's limits, and the
control (the reference with TF32 products in the system's place) is
not."""
import pytest
import torch

from bench import calibrate, registry, testing

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return testing.small_bench(tmp_path_factory.mktemp("bench") / "bench")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small, cell):
    got = testing.run_small(small, cell, seed=3221225473)
    assert got["result"]["correct"], got["numbers"]
    assert got["result"]["failed"] == 0
    assert testing.with_limits(got, cell)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(small, cell):
    got = calibrate.readings(cell, [2147483693], ["control"],
                             torch.device("cpu"), small)
    limits = registry.workload(cell)["limits"]
    nums = got["control"][0]
    assert any(nums[k] > v for k, v in limits.items()), nums
