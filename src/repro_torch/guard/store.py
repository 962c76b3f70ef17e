"""Durable checkpoint store: atomic pair commits, retention, safe fallback
(copy of ``repro/guard/store.py``: stdlib only, the same on-disk layout,
so a store written by either package lists and verifies in the other; the
payload inside is each package's own checkpoint).

``repro_torch.checkpoint.ckpt`` makes ONE checkpoint atomic (metadata
embedded in the npz, unique staging names, single-rename commit).
``DurableStore``
manages a DIRECTORY of them so a long run can survive torn writes, corrupt
files and crashes mid-save:

* **Staged commits.** ``save(saver, step)`` hands the saver callback a path
  inside a fresh ``staging-<pid>-<uuid>/`` directory; after the saver
  returns, every staged file is checksummed (sha256) into a
  ``manifest.json`` and the WHOLE directory is committed with a single
  ``os.rename`` to ``step-<step:012d>``. A crash at any point before the
  rename leaves only a staging directory, which is never eligible for
  restore — the previous good checkpoint is untouched.
* **Verification.** ``verify(path)`` recomputes every manifest checksum, so
  truncation, bit-flips and missing files are all detected (not just
  "np.load happened to fail").
* **Fallback.** ``restore_latest()`` walks committed checkpoints newest to
  oldest, returning the first one that verifies; torn/corrupt ones are
  reported via the ``on_bad`` callback (the supervisor logs them into the
  incident report) and skipped.
* **Retention.** keep-last-K (default 3): after each commit the oldest
  committed checkpoints beyond K are deleted. The newest checkpoint is
  never deleted, and retention runs AFTER the new commit, so there is no
  window with zero good checkpoints.

The store is agnostic to what a checkpoint IS: the saver callback may be
``Experiment.save`` or a raw ``ckpt.save`` lambda — it just writes its
file(s) under the staging dir (every file checksummed).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import uuid
from pathlib import Path
from typing import Callable, List, Optional

MANIFEST = "manifest.json"
PAYLOAD = "state.npz"
_STEP_RE = re.compile(r"^step-(\d{12})$")


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed verification (torn, truncated or
    bit-flipped); carries the path and the first failing file."""

    def __init__(self, path: Path, reason: str):
        super().__init__(f"{path}: {reason}")
        self.path = Path(path)
        self.reason = reason


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class DurableStore:
    """Keep-last-K durable checkpoints under one directory.

    ``save`` commits atomically; ``restore_latest`` verifies and falls back
    past bad checkpoints; ``payload(path)`` is the npz to hand to
    ``Experiment.restore`` / ``ckpt.restore``.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep={keep} must be >= 1")
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)
        # test seam for the chaos harness: called with the fully-staged dir
        # right before the commit rename (guard.chaos kills the process
        # here to exercise the torn-commit window)
        self._pre_commit_hook: Optional[Callable[[Path], None]] = None

    # -------------------------------------------------------------- listing
    def checkpoints(self) -> List[Path]:
        """Committed checkpoint dirs, oldest first (staging dirs excluded)."""
        out = [p for p in self.dir.iterdir()
               if p.is_dir() and _STEP_RE.match(p.name)]
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        cks = self.checkpoints()
        return int(_STEP_RE.match(cks[-1].name).group(1)) if cks else None

    @staticmethod
    def step_of(path: Path) -> int:
        m = _STEP_RE.match(Path(path).name)
        if not m:
            raise ValueError(f"{path}: not a committed checkpoint dir")
        return int(m.group(1))

    @staticmethod
    def payload(path: Path) -> str:
        """The npz inside a committed checkpoint dir (restore entry point)."""
        return str(Path(path) / PAYLOAD)

    # --------------------------------------------------------------- saving
    def save(self, saver: Callable[[str], None], step: int) -> Path:
        """Stage, checksum, and atomically commit one checkpoint.

        ``saver(npz_path)`` writes the checkpoint files into the staging
        dir (e.g. ``Experiment.save`` — one npz). Returns
        the committed directory. Re-saving an existing step replaces it
        atomically (``os.replace`` semantics are not portable for
        directories, so the old dir is swapped out of the way first)."""
        staging = self.dir / f"staging-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        staging.mkdir()
        try:
            saver(str(staging / PAYLOAD))
            files = sorted(p for p in staging.iterdir() if p.is_file())
            if not files:
                raise RuntimeError(f"saver wrote nothing into {staging}")
            manifest = {
                "version": 1, "step": int(step),
                "files": {p.name: {"sha256": _sha256(p),
                                   "bytes": p.stat().st_size}
                          for p in files},
            }
            mtmp = staging / (MANIFEST + ".tmp")
            mtmp.write_text(json.dumps(manifest, indent=1))
            os.replace(mtmp, staging / MANIFEST)
            final = self.dir / f"step-{int(step):012d}"
            old = None
            if final.exists():                      # re-save of same step
                old = self.dir / f"replaced-{uuid.uuid4().hex[:8]}"
                os.rename(final, old)
            if self._pre_commit_hook is not None:
                self._pre_commit_hook(staging)
            os.rename(staging, final)               # THE commit point
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._retain()
        return final

    def _retain(self) -> None:
        for stale in self.checkpoints()[:-self.keep]:
            shutil.rmtree(stale, ignore_errors=True)

    # ---------------------------------------------------------- restoring
    def verify(self, path: Path) -> None:
        """Raise ``CheckpointCorrupt`` unless every manifest checksum holds.

        Catches every corruption mode the chaos harness injects: a missing
        manifest (commit rename never happened — but those dirs are not
        listed anyway), truncation (size/checksum mismatch), bit-flips
        (checksum mismatch) and deleted payload files."""
        path = Path(path)
        mpath = path / MANIFEST
        if not mpath.exists():
            raise CheckpointCorrupt(path, "no manifest (torn commit)")
        try:
            manifest = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorrupt(path, f"unreadable manifest: {e}")
        for name, want in manifest.get("files", {}).items():
            f = path / name
            if not f.exists():
                raise CheckpointCorrupt(path, f"missing file {name}")
            if f.stat().st_size != want["bytes"]:
                raise CheckpointCorrupt(
                    path, f"{name}: size {f.stat().st_size} != "
                          f"{want['bytes']} (truncated?)")
            if _sha256(f) != want["sha256"]:
                raise CheckpointCorrupt(path, f"{name}: checksum mismatch")

    def restore_latest(
            self,
            on_bad: Optional[Callable[[CheckpointCorrupt], None]] = None,
    ) -> Optional[Path]:
        """The newest checkpoint dir that VERIFIES, or None when no good
        checkpoint exists. Corrupt/torn checkpoints are skipped (newest
        first), each reported through ``on_bad`` — recovery must degrade to
        an older good state, never die on a bad newest one."""
        for path in reversed(self.checkpoints()):
            try:
                self.verify(path)
                return path
            except CheckpointCorrupt as bad:
                if on_bad is not None:
                    on_bad(bad)
        return None

    # ------------------------------------------------------------- hygiene
    def clean_staging(self) -> int:
        """Delete leftover staging dirs from crashed saves (supervisor
        startup hygiene). Never touches committed checkpoints. Returns the
        number removed. Only call when no other process is mid-save into
        this store."""
        n = 0
        for p in self.dir.iterdir():
            if p.is_dir() and (p.name.startswith("staging-")
                               or p.name.startswith("replaced-")):
                shutil.rmtree(p, ignore_errors=True)
                n += 1
        return n
