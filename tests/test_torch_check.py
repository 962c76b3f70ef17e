"""repro_torch.check: the port's lint rules (fixture pairs, suppressions,
baseline, CLI, a self-scan of the port) and its dynamic gates on the CPU.

The cases of ``tests/test_check.py`` whose rule carries over to torch are
ported here (R001, R004, R005, R006, suppressions, baseline, CLI exit
codes, ``chunk_signatures``); R002 and R003 have torch meanings (a draw
without an explicit generator; control flow on a tensor's value in a
captured scope), each with a firing and a clean case. The dynamic gates
run the ``smoke`` preset: clean, with D001 reporting that it did not run
(no card); an injected capture per chunk, or an extra chunk, fires D002; a
NaN parameter or a tree write outside the leaves fires D003.
"""
import json
import os
import textwrap

import pytest
import torch

from repro_torch.check import dynamic, lint as lint_mod, report
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.dynamic import chunk_signatures, run_sanitizers
from repro_torch.check.lint import lint_paths, lint_source
from repro_torch.check.report import Finding
from repro_torch.rl import runner as runner_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint(src, path="src/repro_torch/rl/fixture.py", **kw):
    return lint_source(textwrap.dedent(src), path, **kw)


def rules_of(findings):
    return sorted({f.rule for f in findings})


def of(rule, findings):
    return [f for f in findings if f.rule == rule]


# --------------------------------------------------------------------- R001

BAD_R001 = """
    import time
    import torch

    def step(x):
        t = time.time()
        return x + t

    def run(xs):
        return torch.func.vmap(step)(xs)
"""

GOOD_R001 = """
    import time
    import torch

    def step(x, t):
        return x + t

    def host_side(x):
        return torch.func.vmap(step, in_dims=(0, None))(x, time.time())
"""


def test_r001_fires_on_clock_in_vmapped_function():
    fs = of("R001", lint(BAD_R001))
    assert len(fs) == 1 and "time.time" in fs[0].message
    assert fs[0].line == 6


def test_r001_clean_on_host_side_clock():
    assert not of("R001", lint(GOOD_R001))


def test_r001_reaches_through_helper_and_partial():
    src = """
        import functools
        import numpy as np
        from torch.func import grad

        def noise():
            return np.random.rand()

        def loss(p, x):
            return (p * x).sum() + noise()

        def run(p, x):
            return grad(functools.partial(loss, x=x))(p)
    """
    fs = of("R001", lint(src))
    assert len(fs) == 1 and "np.random.rand" in fs[0].message


def test_r001_resolves_import_aliases_and_graph_bodies():
    src = """
        import torch
        from numpy import random as nprand

        def replay(graph, x):
            with torch.cuda.graph(graph):
                y = x + nprand.normal()
            return y
    """
    assert rules_of(lint(src)) == ["R001"]


def test_r001_autograd_function_methods_are_captured():
    src = """
        import random
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(x):
                return x * random.random()
    """
    assert len(of("R001", lint(src))) == 1


# --------------------------------------------------------------------- R002

BAD_R002 = """
    import torch

    def init(n):
        a = torch.randn(n)
        b = torch.empty(n).uniform_(-1, 1)
        c = torch.rand_like(a)
        return a + b + c
"""

GOOD_R002 = """
    import torch

    def init(n, gen):
        a = torch.randn(n, generator=gen)
        b = torch.empty(n).uniform_(-1, 1, generator=gen)
        return a + b + torch.zeros_like(a)
"""


def test_r002_fires_on_draws_without_a_generator():
    fs = of("R002", lint(BAD_R002))
    assert [f.line for f in fs] == [5, 6, 7]
    assert "torch.randn() without generator=" in fs[0].message
    assert "uniform_" in fs[1].message and "global" in fs[2].message


def test_r002_clean_with_explicit_generators():
    assert not of("R002", lint(GOOD_R002))


# --------------------------------------------------------------------- R003

BAD_R003 = """
    import torch

    def step(x):
        y = torch.sum(x)
        if y > 0:
            return x
        return -x

    def run(xs):
        return torch.func.vmap(step)(xs)
"""

GOOD_R003 = """
    import torch

    def step(x):
        y = torch.sum(x)
        return torch.where(y > 0, x, -x)

    def run(xs):
        return torch.func.vmap(step)(xs)
"""


def test_r003_fires_on_tensor_branch():
    fs = of("R003", lint(BAD_R003))
    assert len(fs) == 1 and "if" in fs[0].message and fs[0].line == 6


def test_r003_clean_on_where():
    assert not of("R003", lint(GOOD_R003))


def test_r003_static_config_and_structure_are_clean():
    src = """
        import torch

        @torch.library.custom_op("fixture::attend", mutates_args=())
        def attend(q: torch.Tensor, causal: bool) -> torch.Tensor:
            s = torch.mm(q, q.t())
            if causal and q.ndim == 2 and s.shape[0] > 1 and q.numel():
                s = torch.tril(s)
            if s is None or isinstance(s, tuple) or len(q) > 3:
                return q
            return s if q.dtype == torch.float32 else s.float()
    """
    assert not of("R003", lint(src))


def test_r003_fires_on_tensor_parameter_assert_and_ternary():
    src = """
        import torch

        def clip(x):
            assert x.max() > 0
            return torch.log(x) if x.sum() else x

        def run(xs):
            return torch.func.vmap(clip)(xs)
    """
    fs = of("R003", lint(src))
    assert sorted(f.message.split()[1] for f in fs) == ["assert", "ternary"]


def test_r003_silent_outside_captured_scopes():
    assert not of("R003", lint(BAD_R003.replace(
        "torch.func.vmap(step)(xs)", "step(xs)")))


# --------------------------------------------------------------------- R004

BAD_R004 = """
    import torch

    def drive(state):
        loss = torch.mean(state)
        if float(loss) > 1e3:
            raise RuntimeError("diverged")
        return state
"""

GOOD_R004 = """
    import numpy as np

    def drive(n):
        scores = np.zeros(n)
        return scores.tolist(), float(scores.max())
"""


def test_r004_fires_in_loop_module():
    fs = of("R004", lint(BAD_R004, path="src/repro_torch/rl/runner.py"))
    assert len(fs) == 1 and "float" in fs[0].message


def test_r004_numpy_values_are_not_syncs():
    assert not of("R004", lint(GOOD_R004,
                               path="src/repro_torch/rl/runner.py"))


@pytest.mark.parametrize("call", ["out.item()", "out.cpu()",
                                  "out.tolist()", "torch.cuda.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_r004_sync_calls_fire(call):
    src = f"""
        import torch

        def drive(out):
            return {call}
    """
    assert of("R004", lint(src, path="src/repro_torch/replay/device.py"))


def test_r004_silent_outside_loop_modules_and_captures():
    assert not of("R004", lint(BAD_R004, path="src/repro_torch/obs/report.py"))


def test_r004_fires_in_a_captured_scope_anywhere():
    src = """
        import torch

        def body(x):
            return x.item()

        def run(xs):
            return torch.func.vmap(body)(xs)
    """
    assert of("R004", lint(src, path="src/repro_torch/obs/report.py"))


# --------------------------------------------------------------------- R005

def test_r005_flags_unreachable_module(tmp_path):
    (tmp_path / ".git").mkdir()
    src = tmp_path / "src" / "pkg"
    src.mkdir(parents=True)
    (src / "used.py").write_text("VALUE = 1\n")
    (src / "orphan.py").write_text("import math\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_used.py").write_text("from pkg.used import VALUE\n")
    fs = lint_paths([str(tmp_path / "src")], root=str(tmp_path))
    assert [f.file for f in of("R005", fs)] == ["src/pkg/orphan.py"]


def test_r005_main_block_and_m_strings_are_entrypoints(tmp_path):
    (tmp_path / ".git").mkdir()
    src = tmp_path / "src" / "repro_torch"
    src.mkdir(parents=True)
    (src / "cli.py").write_text(
        "DOC = 'python -m repro_torch.tool'\n\n"
        "if __name__ == \"__main__\":\n    print(DOC)\n")
    (src / "tool.py").write_text("X = 1\n")
    fs = lint_paths([str(tmp_path / "src")], root=str(tmp_path))
    assert not of("R005", fs)


# --------------------------------------------------------------------- R006

BAD_R006 = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class TrainSpec:
        lr: float = 1e-3
        batch: int = 32

        def __post_init__(self):
            if self.lr <= 0:
                raise ValueError("lr must be positive")
"""

GOOD_R006 = BAD_R006 + """
            if self.batch <= 0:
                raise ValueError("batch must be positive")
"""


def test_r006_fires_on_uncovered_field():
    fs = of("R006", lint(BAD_R006))
    assert len(fs) == 1 and "TrainSpec.batch" in fs[0].message


def test_r006_clean_when_all_fields_checked():
    assert not of("R006", lint(GOOD_R006))


def test_r006_fires_on_missing_validator():
    src = """
        import dataclasses

        @dataclasses.dataclass
        class RunSpec:
            steps: int = 10
    """
    fs = of("R006", lint(src))
    assert len(fs) == 1 and "no __post_init__/validate" in fs[0].message


def test_r006_table_driven_validator_covers():
    src = """
        import dataclasses

        _SECTIONS = (("alpha", int), ("beta", float))

        @dataclasses.dataclass
        class TableSpec:
            alpha: int = 1
            beta: float = 2.0

            def __post_init__(self):
                for name, cls in _SECTIONS:
                    if not isinstance(getattr(self, name), cls):
                        raise ValueError(name)
    """
    assert not of("R006", lint(src))


def test_r006_ignores_non_spec_dataclasses():
    src = """
        import dataclasses

        @dataclasses.dataclass
        class Record:
            value: int = 0
    """
    assert not of("R006", lint(src))


# ------------------------------------------------------------- suppressions

def test_suppression_with_reason_silences():
    src = BAD_R001.replace(
        "t = time.time()",
        "t = time.time()  # check: disable=R001 -- a capture-time stamp")
    assert not lint(src)


def test_suppression_comment_above_silences():
    src = BAD_R001.replace(
        "t = time.time()",
        "# check: disable=R001 -- a capture-time stamp\n"
        "        t = time.time()")
    assert not lint(src)


def test_suppression_without_reason_is_r000():
    src = BAD_R001.replace("t = time.time()",
                           "t = time.time()  # check: disable=R001")
    assert rules_of(lint(src)) == ["R000", "R001"]


def test_suppression_only_silences_named_rule():
    src = BAD_R003.replace(
        "if y > 0:", "if y > 0:  # check: disable=R001 -- wrong rule id")
    assert rules_of(lint(src)) == ["R003"]


# ----------------------------------------------------------------- baseline

def test_baseline_round_trip(tmp_path):
    f = Finding(rule="R004", file="src/x.py", line=3, message="m",
                hint="h", snippet="v = t.item()")
    path = tmp_path / "b.json"
    report.write_baseline([f], path, reason="legacy")
    loaded = report.load_baseline(path)
    assert loaded == {("src/x.py", "R004", "v = t.item()"): "legacy"}
    assert report.split_new([f], loaded) == ([], [f])
    moved = Finding(rule="R004", file="src/x.py", line=99, message="m",
                    hint="h", snippet="v = t.item()")
    assert report.split_new([moved], loaded) == ([], [moved])
    edited = Finding(rule="R004", file="src/x.py", line=3, message="m",
                     hint="h", snippet="w = t.item()")
    assert report.split_new([edited], loaded)[0] == [edited]


def test_baseline_requires_reason(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"version": 1, "findings": [
        {"file": "a.py", "rule": "R001", "snippet": "x", "line": 1}]}))
    with pytest.raises(report.BaselineError):
        report.load_baseline(path)


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(BAD_R001))
    (tmp_path / ".git").mkdir()
    assert lint_mod.main([str(bad), "--no-dead"]) == 1
    base = tmp_path / "check_baseline.json"
    assert lint_mod.main([str(bad), "--no-dead", "--write-baseline",
                          "--baseline", str(base)]) == 0
    assert lint_mod.main([str(bad), "--no-dead",
                          "--baseline", str(base)]) == 0
    capsys.readouterr()
    assert check_main(["lint", str(bad), "--no-dead", "--json",
                       "--no-baseline"]) == 1
    assert [f["rule"] for f in json.loads(capsys.readouterr().out)] \
        == ["R001"]
    assert check_main([]) == 2 and check_main(["nope"]) == 2


# ------------------------------------------------------ repo-level contract

def test_self_scan_of_the_port_is_clean_with_an_empty_baseline():
    """src/repro_torch has no finding: each is mended or suppressed with
    its reason, none grandfathered."""
    findings = lint_paths([os.path.join(ROOT, "src", "repro_torch")],
                          root=ROOT)
    assert not findings, report.render(findings)
    with open(os.path.join(ROOT, "check_baseline.json")) as f:
        assert json.load(f)["findings"] == []


def test_chunk_signatures_schedule():
    # eval every 4, srank every 5, 10 steps: stops at 4, 5, 8, 10
    assert chunk_signatures(0, 10, 4, 5) == [
        (4, True, False), (1, False, True), (3, True, False),
        (2, False, True)]
    assert chunk_signatures(6, 10, 4, 0) == [(2, True, False),
                                             (2, False, False)]


# ------------------------------------------------------------------ dynamic

def test_dynamic_smoke_is_clean_and_d001_did_not_run(capsys):
    findings, status = run_sanitizers("smoke", device="cpu")
    assert findings == []
    assert status["D001"].startswith("not run")
    assert status["D002"] == status["D003"] == "passed"
    assert dynamic.main(["--preset", "smoke", "--device", "cpu",
                         "--steps", "6", "--override",
                         "execution.mesh_shards=4"]) == 0
    out = capsys.readouterr().out
    assert "D001: not run" in out and "clean" in out


def test_dynamic_d002_fires_on_a_capture_per_chunk(monkeypatch):
    inner = runner_mod.Trainer.chunk_fn

    def capturing(self, n_steps, do_eval, do_srank=False):
        self.captures += 1
        return inner(self, n_steps, do_eval, do_srank)
    monkeypatch.setattr(runner_mod.Trainer, "chunk_fn", capturing)
    findings, status = run_sanitizers("smoke", device="cpu")
    assert rules_of(findings) == ["D002"] and status["D002"] == "failed"


def test_dynamic_d002_fires_on_an_extra_chunk(monkeypatch):
    inner = runner_mod.Trainer.chunk_fn

    def split(self, n_steps, do_eval, do_srank=False):
        if n_steps == 1:
            return inner(self, n_steps, do_eval, do_srank)
        head, tail = self.chunk_fn(1, False), self.chunk_fn(
            n_steps - 1, do_eval, do_srank)
        return lambda ls: tail(head(ls)[0])
    monkeypatch.setattr(runner_mod.Trainer, "chunk_fn", split)
    findings, _ = run_sanitizers("smoke", device="cpu")
    assert rules_of(findings) == ["D002"]
    assert "the scheduler predicts" in findings[0].message


@pytest.mark.parametrize("fault", ["nan", "tree"])
def test_dynamic_d003_fires(monkeypatch, fault):
    from repro_torch.replay import device as device_mod
    clone = runner_mod.clone_state

    def faulty(ls):
        out = clone(ls)
        if fault == "nan":
            with torch.no_grad():
                runner_mod.tree_leaves(out.agent["params"])[0].view(-1)[0] \
                    = float("nan")
        else:
            set_ = device_mod.sumtree_set
            monkeypatch.setattr(
                device_mod, "sumtree_set",
                lambda tree, idx, value: set_(tree, idx + tree.shape[-1],
                                              value))
        return out
    monkeypatch.setattr(runner_mod, "clone_state", faulty)
    findings, status = run_sanitizers("smoke", device="cpu")
    assert rules_of(findings) == ["D003"] and status["D003"] == "failed"
    assert ("IndexError" if fault == "tree" else "non-finite") \
        in findings[0].message


def test_dynamic_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_sanitizers("smoke")
