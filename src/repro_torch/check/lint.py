"""Static half of ``repro_torch.check``: walk files, run rules, diff the
baseline (port of ``repro/check/lint.py``; the rules are
``repro_torch.check.rules``).

Usage::

    python -m repro_torch.check lint src/repro_torch   # vs check_baseline.json
    python -m repro_torch.check lint --json src/repro_torch
    python -m repro_torch.check lint --write-baseline src/repro_torch

Exit codes: 0 clean (or only grandfathered findings), 1 new findings,
2 usage/baseline error.

Suppressions: ``# check: disable=R001 -- reason`` on the flagged line or
the line directly above silences that rule there. The reason is
mandatory; a bare ``disable=`` earns an R000 finding instead.

R005 (dead modules) is a whole-tree property, so it only runs when the
lint targets include a directory (single-file invocations skip it).
"""
from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.check import report, rules
from repro_torch.check.report import Finding

# modules whose whole body is the training hot loop: R004 applies to every
# scope in them, not just captured ones (a sync anywhere there stalls the
# card's queue)
LOOP_MODULES = (
    "src/repro_torch/rl/runner.py",
    "src/repro_torch/rl/sweep.py",
    "src/repro_torch/replay/",
    "src/repro_torch/kernels/",
)

_SUPPRESS_RE = re.compile(
    r"#\s*check:\s*disable=([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)"
    r"(?:\s*--\s*(.*))?")


def _repo_root(start: Optional[str] = None) -> str:
    """Nearest ancestor containing .git (fallback: cwd)."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, ".git")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def _relpath(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), root)
    return rel.replace(os.sep, "/")


# -------------------------------------------------------------- suppressions

def parse_suppressions(source: str) -> Tuple[Dict[int, Set[str]],
                                             List[Tuple[int, str]]]:
    """-> ({line: {rule ids suppressed on that line}}, [(line, bad-comment)]).

    A comment on its own line suppresses the NEXT line as well, so the
    usual style — comment above the flagged statement — works.
    """
    by_line: Dict[int, Set[str]] = {}
    bad: List[Tuple[int, str]] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",")}
        reason = (m.group(2) or "").strip()
        if not reason:
            bad.append((i, text.strip()))
            continue
        by_line.setdefault(i, set()).update(ids)
        if text.strip().startswith("#"):  # standalone comment line
            by_line.setdefault(i + 1, set()).update(ids)
    return by_line, bad


def _apply_suppressions(findings: List[Finding], source: str,
                        path: str) -> List[Finding]:
    by_line, bad = parse_suppressions(source)
    out = [f for f in findings
           if f.rule not in by_line.get(f.line, ())]
    lines = source.splitlines()
    for line, _text in bad:
        out.append(Finding(
            rule="R000", file=path, line=line,
            message="suppression comment without a reason",
            hint="write '# check: disable=R00x -- why this is safe'; a "
                 "reason-less suppression is indistinguishable from a "
                 "mistake",
            snippet=lines[line - 1].strip() if line <= len(lines) else ""))
    return out


# ------------------------------------------------------------- per-file lint

def lint_source(source: str, path: str, *,
                loop_module: Optional[bool] = None) -> List[Finding]:
    """Run the per-module rules (R001-R004, R006) on one source string.

    ``path`` should be repo-relative; it anchors findings and decides
    loop-module status when ``loop_module`` is None.
    """
    if loop_module is None:
        loop_module = any(path.startswith(p) or path == p.rstrip("/")
                          for p in LOOP_MODULES)
    try:
        mod = rules.ModuleAnalysis(path, source)
    except SyntaxError as e:
        return [Finding(rule="R000", file=path, line=e.lineno or 1,
                        message=f"syntax error: {e.msg}",
                        hint="fix the parse error; no other rules ran",
                        snippet=(e.text or "").strip())]
    findings: List[Finding] = []
    findings += rules.r001_host_impurity(mod)
    findings += rules.r002_implicit_generator(mod)
    findings += rules.r003_tensor_branch(mod)
    findings += rules.r004_host_sync(mod, loop_module)
    findings += rules.r006_spec_validation(mod)
    return _apply_suppressions(findings, source, path)


# --------------------------------------------------------- R005 dead modules

def _module_name(rel: str) -> Optional[str]:
    """repo-relative path -> importable dotted name (src/ layout aware)."""
    if not rel.endswith(".py"):
        return None
    p = rel[:-3]
    if p.startswith("src/"):
        p = p[len("src/"):]
    name = p.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _imports_of(tree: ast.Module, self_name: str) -> Set[str]:
    """Dotted module names referenced by import statements + ``-m`` style
    string constants (``python -m repro_torch.obs.report`` in helptext
    and docs)."""
    out: Set[str] = set()
    pkg = self_name.rsplit(".", 1)[0] if "." in self_name else ""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = self_name.split(".")
                # relative: level 1 = current package
                base = base[: len(base) - node.level] \
                    if len(base) >= node.level else []
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod:
                out.add(mod)
                for a in node.names:
                    out.add(f"{mod}.{a.name}")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in re.finditer(r"\brepro_torch(?:\.\w+)+", node.value):
                out.add(m.group(0))
    del pkg
    return out


# CLI modules invoked as `python -m repro_torch.<...>` (the command surface
# the docs advertise) — entrypoints for R005 even if their inline
# `if __name__ == "__main__"` block ever moves behind a console script
M_ENTRYPOINTS = (
    "src/repro_torch/launch/serve_policy.py",
    "src/repro_torch/launch/quickstart.py",
    "src/repro_torch/guard/supervise.py",
    "src/repro_torch/obs/report.py",
)


def r005_dead_modules(files: Dict[str, str], root: str) -> List[Finding]:
    """Files unreachable from any entrypoint via the import graph.

    Entrypoints: tests/, benchmarks/, examples/, conftest.py, the port's
    rl/ package (the public API), ``__main__.py`` files, the ``-m`` CLI
    modules in ``M_ENTRYPOINTS``, and any file with an
    ``if __name__ == "__main__"`` block. Namespace packages (no
    __init__.py) resolve fine because matching is by module NAME prefix.
    """
    mod_to_file: Dict[str, str] = {}
    parsed: Dict[str, ast.Module] = {}
    for rel, src in files.items():
        name = _module_name(rel)
        if name is None:
            continue
        try:
            parsed[rel] = ast.parse(src, filename=rel)
        except SyntaxError:
            continue  # surfaced by lint_source already
        mod_to_file[name] = rel

    def is_entry(rel: str, tree: ast.Module) -> bool:
        if rel.startswith(("tests/", "benchmarks/", "examples/")):
            return True
        if rel.endswith(("conftest.py", "__main__.py")):
            return True
        if rel.startswith("src/repro_torch/rl/") or rel in M_ENTRYPOINTS:
            return True
        for node in tree.body:
            if isinstance(node, ast.If):
                t = node.test
                if isinstance(t, ast.Compare) \
                        and isinstance(t.left, ast.Name) \
                        and t.left.id == "__name__":
                    return True
        return False

    reached: Set[str] = set()
    frontier = [rel for rel, tree in parsed.items() if is_entry(rel, tree)]
    reached.update(frontier)
    while frontier:
        rel = frontier.pop()
        name = _module_name(rel) or ""
        for imp in _imports_of(parsed[rel], name):
            # `import a.b.c` reaches a, a.b, a.b.c; `from m import X`
            # reaches m and possibly module m.X
            parts = imp.split(".")
            for i in range(1, len(parts) + 1):
                target = mod_to_file.get(".".join(parts[:i]))
                if target is not None and target not in reached:
                    reached.add(target)
                    frontier.append(target)

    out = []
    for rel in sorted(parsed):
        if rel in reached or not rel.startswith("src/"):
            continue
        out.append(Finding(
            rule="R005", file=rel, line=1,
            message="module is unreachable from any entrypoint "
                    "(tests/, benchmarks/, examples/, rl/, CLI mains)",
            hint="delete it, or wire it to an entrypoint; dead code "
                 "still costs review and refactoring attention",
            snippet=f"<module {_module_name(rel)}>"))
    return out


# -------------------------------------------------------------- entry point

def _collect_files(paths: Sequence[str], root: str) -> Dict[str, str]:
    """Expand path args into {repo-relative path: source}."""
    out: Dict[str, str] = {}
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            with open(ap) as f:
                out[_relpath(ap, root)] = f.read()
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            ".pytest_cache")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        fp = os.path.join(dirpath, fn)
                        with open(fp) as f:
                            out[_relpath(fp, root)] = f.read()
        else:
            raise FileNotFoundError(p)
    return out


def lint_paths(paths: Sequence[str], *, root: Optional[str] = None,
               dead_modules: bool = True) -> List[Finding]:
    """Lint files/directories; adds R005 when a directory was given.

    For R005 the import graph must see the whole repo (entrypoints live in
    tests//benchmarks//examples/ even when only src/ is linted), so the
    graph is built from the full tree while findings stay restricted to
    the requested paths.
    """
    root = root or _repo_root(paths[0] if paths else None)
    targets = _collect_files(paths, root)
    findings: List[Finding] = []
    for rel in sorted(targets):
        findings += lint_source(targets[rel], rel)
    if dead_modules and any(os.path.isdir(p) for p in paths):
        graph_files = _collect_files([root], root)
        dead = r005_dead_modules(graph_files, root)
        findings += [f for f in dead if f.file in targets]
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.check lint",
        description="torch-aware static analysis for the port's "
                    "determinism and no-sync contract (rules R001-R006)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline json (default: <repo>/check_baseline"
                         ".json if present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit")
    ap.add_argument("--no-dead", action="store_true",
                    help="skip R005 dead-module analysis")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as json")
    args = ap.parse_args(argv)

    paths = args.paths or ["src/repro_torch"]
    root = _repo_root(paths[0])
    try:
        findings = lint_paths(paths, root=root,
                              dead_modules=not args.no_dead)
    except (FileNotFoundError, OSError) as e:
        print(f"repro_torch.check: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root,
                                                  "check_baseline.json")
    if args.write_baseline:
        report.write_baseline(findings, baseline_path,
                              reason="grandfathered by --write-baseline; "
                                     "review before relying on this code")
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = None
    if not args.no_baseline and os.path.exists(baseline_path):
        try:
            baseline = report.load_baseline(baseline_path)
        except (report.BaselineError, ValueError) as e:
            print(f"repro_torch.check: {e}", file=sys.stderr)
            return 2
    new, old = report.split_new(findings, baseline)

    if args.json:
        print(report.to_json(new))
    else:
        print(report.render(new))
        if old:
            print(f"({len(old)} grandfathered finding(s) suppressed by "
                  f"{os.path.basename(baseline_path)})")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
