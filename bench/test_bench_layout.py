"""The benchmark's files: each piece found by its name, a new cell found
as a new file, the contract's shape of ``BENCHMARK.json`` and of the
result line, and no import of JAX or of the JAX package."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness, registry, testing

BENCH = registry.benchmark()
ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = registry.workload(cell)
    assert spec["config"] == entry["config"] and spec["chips"] == 1
    assert spec["why"] == entry["why"] and len(entry["why"]) <= 200
    config = registry.config(spec["config"])
    assert config["name"] == entry["config"]
    assert set(spec["limits"]) <= set(harness.judge.NUMBERS)
    got = registry.cell_metrics(BENCH, cell)
    e2e = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) == 2
    assert got["per_layer"]
    assert {m["moves"] for m in got["per_layer"]} == e2e - {"setup_s"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_load_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"bench/configs/{config}.json"
    got = registry.config(config)
    assert got["reduced"] == entry["reduced"] == []
    assert got["spec"]["network"]["num_units"] == 2048


@pytest.mark.parametrize("kind,metric", [
    ("end_to_end", m["name"]) for m in BENCH["end_to_end"]] + [
    ("layer_metrics", m["name"]) for m in BENCH["per_layer"]])
def test_metric_readers_load_by_name(kind, metric):
    mod = registry.reader(kind, metric)
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    assert mod.UNIT == entry["unit"] and callable(mod.read)
    if kind == "layer_metrics":
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]


def test_a_new_cell_is_a_new_file(tmp_path):
    d = testing.small_bench(tmp_path / "bench")
    cell = json.loads((d / "workloads" / "sac-densenet2048.graph.json")
                      .read_text())
    cell["why"] = "the graph cell again under another name"
    (d / "workloads" / "sac-densenet2048.again.json").write_text(
        json.dumps(cell))
    e2e = [dict(m, workloads=m["workloads"] + ["sac-densenet2048.again"])
           if m["name"] == "updates_per_s" else m
           for m in BENCH["end_to_end"]]
    bench = dict(BENCH, end_to_end=e2e, workloads=BENCH["workloads"] + [{
        "name": "sac-densenet2048.again", "config": "sac-densenet2048",
        "traffic": "again", "chips": 1, "why": cell["why"]}])
    assert registry.workload("sac-densenet2048.again", d)["why"] == \
        cell["why"]
    per_layer = {m["name"] for m in registry.cell_metrics(
        bench, "sac-densenet2048.again")["per_layer"]}
    assert per_layer == set()       # the accepted cells' lists name it not
    got = testing.run_small(d, "sac-densenet2048.again", bench=bench)
    assert got["result"]["correct"]
    assert set(got["result"]["metrics"]) == {"updates_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contracts_keys(tmp_path, trace):
    """``harness.main`` in a fresh interpreter, as ``bench/run.py`` runs it
    but on the CPU: exit 0, the last line's keys in the contract's order
    (and the forbidden-module check passes there)."""
    d = testing.small_bench(tmp_path / "bench")
    code = (f"import sys, time; sys.path[:0] = {[str(ROOT), str(ROOT / 'src')]!r}\n"
            "from pathlib import Path\nfrom bench import harness\n"
            f"sys.exit(harness.main(['--workload', 'sac-densenet2048.graph', "
            f"'--seed', '4294967311', '--seconds', '0.2', '--trace', "
            f"'{trace}'], time.perf_counter(), bench_dir=Path({str(d)!r}), "
            f"device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert r.stderr.strip().splitlines()[-1].startswith("check ")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    mods = {"torch": None, "repro_torch": None, "repro_torch.rl": None}
    monkeypatch.setattr(harness.sys, "modules", dict(mods))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(harness.sys, "modules",
                        dict(mods, **{"repro.rl": None, "jaxlib": None}))
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "sac-densenet2048.graph", "--seed", "1",
                       "--seconds", "1", "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in registry.BENCH_DIR.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        assert "benchmarks" not in tops, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (registry.BENCH_DIR / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "bench", "dataclasses", "math",
                        "typing", "numpy", "torch"}, (path, tops)
