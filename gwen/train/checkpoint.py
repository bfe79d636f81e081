"""Step-level checkpoint/resume in plain ``.npz`` files.

Extension over the reference, which has no step checkpointing — only MLflow
best-epoch artifact logging (models_gnn.py:384-387; SURVEY §5
"Checkpoint/resume"). Saves the full train state (params, optimizer state,
step) as ``step_<n>.npz`` with retention, and restores into a template
state's structure and shardings.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import jax
import numpy as np

from gwen.npz_io import load_arrays, save_arrays

_STEP_FILE = re.compile(r"^step_(\d+)\.npz$")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils

        leaf = multihost_utils.process_allgather(leaf, tiled=True)
    return np.asarray(jax.device_get(leaf))


class Checkpointer:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:09d}.npz"

    def steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for p in self.directory.iterdir()
            if (m := _STEP_FILE.match(p.name))
        )

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` for ``step`` (synchronously)."""
        if self.latest_step() == step:
            return  # e.g. per-epoch best save colliding with checkpoint_every
        leaves = [_host(x) for x in jax.tree_util.tree_leaves(state)]
        if jax.process_index() != 0:
            return
        tmp = self.directory / f".step_{step:09d}.tmp.npz"
        save_arrays(tmp, leaves)
        os.replace(tmp, self._path(step))
        for old in self.steps()[: -self.max_to_keep or None]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        t_leaves, treedef = jax.tree_util.tree_flatten(state_template)
        leaves = load_arrays(self._path(step))
        if len(leaves) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, template has "
                f"{len(t_leaves)}")
        out = []
        for leaf, tmpl in zip(leaves, t_leaves):
            sharding = getattr(tmpl, "sharding", None)
            out.append(jax.device_put(leaf, sharding) if sharding is not None
                       else leaf)
        return jax.tree_util.tree_unflatten(treedef, out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""
