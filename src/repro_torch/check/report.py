"""Shared finding/report format for ``repro_torch.check`` (port of
``repro/check/report.py``).

Both halves of the subsystem — the static AST linter
(``repro_torch.check.lint``) and the dynamic sanitizer harness
(``repro_torch.check.dynamic``) — emit the same
``Finding`` record: a rule id, a ``file:line`` anchor, a one-line message
and a fix hint. One format means one renderer, one JSON schema, and one
baseline mechanism.

Baselines (``check_baseline.json``) grandfather pre-existing findings so CI
fails only on NEW ones. A baseline entry is keyed by ``(file, rule,
snippet)`` — the stripped source text of the flagged line, not its number —
so unrelated edits that shift line numbers do not invalidate the baseline,
while editing the flagged line itself surfaces the finding again. Every
entry must carry a ``reason`` explaining why the finding is tolerated;
reason-less baselines are rejected (the same contract as inline
``# check: disable=R00x -- reason`` suppressions).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

BASELINE_VERSION = 1

# rule id -> one-line summary, used by ``--explain`` style output and docs
RULES: Dict[str, str] = {
    "R000": "suppression comment without a reason",
    "R001": "clock or host RNG inside a captured scope",
    "R002": "random draw without an explicit torch.Generator",
    "R003": "Python control flow on a tensor's value in a captured scope",
    "R004": "hidden host sync in a captured scope or a loop module",
    "R005": "dead module: unreachable from any entrypoint",
    "R006": "*Spec dataclass field not covered by validate/__post_init__",
    "D001": "synchronizing CUDA call inside the steady-state run",
    "D002": "CUDA graph captures or dispatched chunks off the schedule",
    "D003": "non-finite parameter or bad tree write in one superstep",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, static or dynamic."""
    rule: str                  # "R000".."R006" / "D001".."D003"
    file: str                  # repo-relative posix path (or "<dynamic>")
    line: int                  # 1-indexed; 1 for file-level findings
    message: str               # what is wrong, concretely
    hint: str = ""             # how to fix it
    snippet: str = ""          # stripped source of the flagged line

    def key(self) -> Tuple[str, str, str]:
        """Line-drift-stable baseline identity."""
        return (self.file, self.rule, self.snippet)

    def format(self) -> str:
        out = f"{self.file}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def render(findings: Iterable[Finding]) -> str:
    """Human-readable report, grouped in file/line order."""
    fs = sorted(findings, key=lambda f: (f.file, f.line, f.rule))
    if not fs:
        return "repro_torch.check: clean (no findings)"
    lines = [f.format() for f in fs]
    lines.append(f"repro_torch.check: {len(fs)} finding(s)")
    return "\n".join(lines)


def to_json(findings: Iterable[Finding]) -> str:
    return json.dumps([f.to_dict() for f in findings], indent=2,
                      sort_keys=True)


# ------------------------------------------------------------------ baseline

class BaselineError(ValueError):
    """Malformed baseline file (bad schema, missing reasons)."""


def load_baseline(path) -> Dict[Tuple[str, str, str], str]:
    """``check_baseline.json`` -> {finding key: reason}.

    Every entry must carry a non-empty ``reason`` — a baseline is a list of
    consciously tolerated findings, not a mute button.
    """
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict) or "findings" not in raw:
        raise BaselineError(f"{path}: expected "
                            f'{{"version": 1, "findings": [...]}}')
    out: Dict[Tuple[str, str, str], str] = {}
    for i, e in enumerate(raw["findings"]):
        missing = [k for k in ("file", "rule", "snippet") if k not in e]
        if missing:
            raise BaselineError(f"{path}: entry {i} missing {missing}")
        if not e.get("reason"):
            raise BaselineError(
                f"{path}: entry {i} ({e['rule']} in {e['file']}) has no "
                f"'reason' — baselined findings must say why they are "
                f"tolerated")
        out[(e["file"], e["rule"], e["snippet"])] = e["reason"]
    return out


def write_baseline(findings: Iterable[Finding], path,
                   reason: str = "grandfathered at baseline creation"
                   ) -> None:
    entries = [{"file": f.file, "rule": f.rule, "snippet": f.snippet,
                "line": f.line, "reason": reason}
               for f in sorted(findings,
                               key=lambda f: (f.file, f.line, f.rule))]
    with open(path, "w") as fp:
        json.dump({"version": BASELINE_VERSION, "findings": entries}, fp,
                  indent=2, sort_keys=True)
        fp.write("\n")


def split_new(findings: Iterable[Finding],
              baseline: Optional[Dict[Tuple[str, str, str], str]]
              ) -> Tuple[List[Finding], List[Finding]]:
    """(new findings, grandfathered findings) under ``baseline``."""
    if not baseline:
        return list(findings), []
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old
