"""Checkpoint / resume for full training state.

The reference saves params only once at the very end of a run — a crash
loses everything (SURVEY.md §5: params written at ``norm/runner.py:269``;
an Orbax path exists but is commented out as deprecated,
``utils.py:309-337``). Here the FULL training state — params, every
optimizer state, the device-resident replay buffer, the PRNG key, and the
epoch counter — checkpoints periodically and training resumes exactly.

Each step is one ``<dir>/<step>.npz`` holding the state's leaves in
flattening order (``leaf_<i>``) and their tree paths. A save writes a
temporary file and renames it into place, so a crash mid-save leaves the
previous checkpoint intact; only the newest ``keep`` steps are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np

_STEP_FILE = re.compile(r"(\d+)\.npz$")


class TrainCheckpointer:
    """Periodic, atomic, keep-N checkpoints of one run's state pytree."""

    def __init__(self, directory: str, keep: int = 3, every: int = 1):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(keep, 1)
        self._every = max(every, 1)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.npz")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self._dir):
            m = _STEP_FILE.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def maybe_save(self, step: int, state: Any) -> bool:
        """Save if ``step`` hits the cadence. Returns True if saved."""
        if step % self._every != 0:
            return False
        leaves_with_paths, _ = jax.tree_util.tree_flatten_with_path(state)
        arrays = {
            f"leaf_{i}": np.asarray(leaf)
            for i, (_, leaf) in enumerate(leaves_with_paths)
        }
        arrays["paths"] = np.array(
            [jax.tree_util.keystr(p) for p, _ in leaves_with_paths]
        )
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as fp:
            np.savez(fp, **arrays)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[: -self._keep]:
            os.remove(self._path(old))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure, shapes and dtypes of ``template``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir!r}")
        leaves_with_paths, treedef = jax.tree_util.tree_flatten_with_path(
            template
        )
        with np.load(self._path(step)) as data:
            paths = [str(p) for p in data["paths"]]
            expected = [jax.tree_util.keystr(p) for p, _ in leaves_with_paths]
            if paths != expected:
                raise ValueError(
                    f"checkpoint {self._path(step)} holds another state tree"
                )
            leaves = []
            for i, (path, ref) in enumerate(leaves_with_paths):
                arr = data[f"leaf_{i}"]
                shape, dtype = np.shape(ref), np.result_type(ref)
                if arr.shape != shape or arr.dtype != dtype:
                    raise ValueError(
                        f"checkpoint leaf {jax.tree_util.keystr(path)} is "
                        f"{arr.dtype}{arr.shape}, expected {dtype}{shape}"
                    )
                leaves.append(jax.numpy.asarray(arr))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    def clear(self):
        """Delete all saved steps (call when a run COMPLETES: the run's
        artifacts live under trained_models/, and a leftover final
        checkpoint would make the next fresh invocation silently resume
        — i.e. skip — a finished run)."""
        for step in self.all_steps():
            os.remove(self._path(step))

    def close(self):
        """Nothing to release: every save is complete when it returns."""
