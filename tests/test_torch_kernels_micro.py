"""The port's kernel micro-benchmark (``repro_torch.launch.kernels_micro``):
the same rows as the reference's ``benchmarks/kernels_micro.py`` (names
read from that file's source, which is not run), each with a small error
against the plain version. On the CPU the port's functions run their plain
versions, so nothing launches; on the card each call launches its kernel
once (checked by ``chip_smoke.py`` and the card-only test here)."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.launch import kernels_micro

REFERENCE = Path(__file__).resolve().parents[1] / "benchmarks" \
    / "kernels_micro.py"


def _reference_names():
    return re.findall(r'"name":\s*"([a-z0-9_]+)"', REFERENCE.read_text())


def test_rows_match_the_reference_names_on_the_cpu():
    rows = kernels_micro.run(device="cpu", reps=1)
    assert [r["name"] for r in rows] == _reference_names()
    assert len(rows) == 3
    for r in rows:
        assert r["device"] == "cpu" and r["launches"] == 0
        assert r["maxerr"] < 1e-4 and r["us_per_call"] > 0
        assert r["derived"] == f"maxerr={r['maxerr']:.2e}"


def test_main_prints_one_line_per_row(capsys, monkeypatch):
    run = kernels_micro.run
    monkeypatch.setattr(kernels_micro, "run",
                        lambda device: run(device, reps=1))
    kernels_micro.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(",")[0] for ln in lines] == _reference_names()


def test_run_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kernels_micro.run()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_each_row_launches_its_kernel_once_per_call(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    for r in kernels_micro.run(cuda_device, reps=3):
        assert r["launches"] == r["calls"], r
        assert r["maxerr"] < 1e-3, r
