"""Checkpointing (SURVEY.md §5): params + optimizer state + step for the
config-3 training loop, with rotation and resume.

Each step is one ``.npz`` of the state pytree's leaves, written to a
temporary name and renamed into place, so a crash mid-save never leaves a
readable partial checkpoint. numpy is the only dependency.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

_FILE = "state.npz"


class CheckpointManager:
    """Pytree checkpoints under ``<root>/<step>/state.npz``;
    ``restore_latest`` resumes from the newest step and only the newest
    ``max_to_keep`` steps are kept."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(p.name) for p in self.root.iterdir()
                      if p.name.isdigit() and (p / _FILE).is_file())

    def save(self, state: Any, step: int, wait: bool = False) -> None:
        """Write ``state`` for ``step`` (synchronous; ``wait`` is accepted
        for callers written against an asynchronous saver)."""
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
        d = self.root / str(step)
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / (_FILE + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, *leaves)
        os.replace(tmp, d / _FILE)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.root / str(old), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        """The state saved at ``step``, in the structure of ``template``."""
        leaves, treedef = jax.tree_util.tree_flatten(template)
        with np.load(self.root / str(step) / _FILE) as z:
            saved = [z[f"arr_{i}"] for i in range(len(z.files))]
        if len(saved) != len(leaves):
            raise ValueError(
                f"checkpoint {step} holds {len(saved)} arrays, the template "
                f"{len(leaves)}"
            )
        return jax.tree_util.tree_unflatten(
            treedef, [jax.numpy.asarray(s) for s in saved])

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""

    def close(self) -> None:
        """Nothing to release."""
