"""Checkpoint / resume for solver state.

SURVEY.md §5: the reference's persistence is a raw struct fwrite with latent
load bugs (ndarray.c:1356-1404) plus PHP serialization. Here: dtype/shape-
tagged array trees in one portable .npz file (self-describing, host-device
agnostic).

Typical use: checkpoint a receding-horizon controller's warm-start state
(previous U, nominal trajectory, RNG key) so a restarted process resumes
mid-sweep.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np


def _flatten(tree: Any):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def save_checkpoint(path: str, tree: Any, metadata: Dict | None = None) -> None:
    """Save a pytree of arrays to an .npz file."""
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz: {path!r}")
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(jax.device_get(x)) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps(
            {"treedef": str(treedef), "meta": metadata or {}}
        ).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_checkpoint(path: str, like: Any = None) -> Any:
    """Load a pytree from an .npz file; `like` provides the tree structure
    (without it the flat list of leaves is returned)."""
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz: {path!r}")
    data = np.load(path, allow_pickle=False)
    leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(data.files) - 1)]
    if like is not None:
        _, treedef = _flatten(like)
        return jax.tree_util.tree_unflatten(treedef, leaves)
    return leaves
