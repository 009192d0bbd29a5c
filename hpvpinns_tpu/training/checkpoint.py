"""Checkpoint / resume via Orbax.

The reference has no model checkpointing (no tf.train.Saver anywhere); its
only persistence is the AdvDiff results record (scipy.io.savemat,
AdvDiff.py:500-508 — covered by utils/records.py).  Periodic parameter +
optimizer-state checkpointing with resume is this framework's answer to the
missing failure-recovery story (SURVEY.md section 5).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import orbax.checkpoint as ocp


class Checkpointer:
    """Thin Orbax wrapper: save/restore {params, opt_state} keyed by step.

    `keep_last` bounds disk usage: older step directories are deleted after
    each save (0 = keep everything).

    `use_async=True` saves through Orbax's AsyncCheckpointer: the device
    buffers are snapshotted synchronously (cheap for these small pytrees) and
    serialization happens on a background thread — the training loop is not
    blocked by disk IO.  `wait()` (called automatically before restore and by
    the trainer at the end of a run) barriers on outstanding writes."""

    def __init__(self, directory: str, keep_last: int = 3, use_async: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.use_async = use_async
        if use_async:
            self._ckptr = ocp.AsyncCheckpointer(ocp.PyTreeCheckpointHandler())
        else:
            self._ckptr = ocp.PyTreeCheckpointer()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        tree = {"params": params, "opt_state": opt_state}
        if self.keep_last and self.use_async:
            # prune BEFORE issuing the write: only finalized step dirs are
            # listed (in-flight tmp dirs don't match the step_<digits> name),
            # so this never races the background serializer, and save()
            # returns without blocking on IO
            self._prune(keep=self.keep_last - 1)
        self._ckptr.save(self._path(step), tree, force=True)
        if self.keep_last and not self.use_async:
            self._prune()

    def wait(self) -> None:
        """Barrier on outstanding async writes (no-op for sync savers)."""
        if hasattr(self._ckptr, "wait_until_finished"):
            self._ckptr.wait_until_finished()

    def _steps(self):
        import re

        return sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", name))
        )

    def _prune(self, keep: Optional[int] = None) -> None:
        import shutil

        keep = self.keep_last if keep is None else keep
        steps = self._steps()
        drop = steps[:-keep] if keep > 0 else steps
        for step in drop:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None):
        """Restore (step, {params, opt_state}). `like` provides the target
        pytree structure/shardings (pass {"params": ..., "opt_state": ...})."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if like is not None:
            restored = self._ckptr.restore(self._path(step), item=like)
        else:
            restored = self._ckptr.restore(self._path(step))
        return step, restored
