"""Checkpoint/resume for sampler state.

The reference has NO resume — a crash loses the run, its only
persistence being the append-only .res rows [SURVEY.md §5].  Here
checkpointing is first-class: the full sampler state (chain positions,
cached log-posts/gradients, RNG keys, adaptation state, iteration
counter, accumulated samples) is one pytree, saved atomically as one
npz file at the given path (written to a temporary name, then renamed
over the old one) and restored bit-exactly, so a killed run resumes
mid-sampling with identical results to an uninterrupted one
(tests/test_checkpoint.py).
"""
from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomically save a pytree checkpoint to `path` (overwrites)."""
    leaves = jax.tree_util.tree_leaves(tree)
    final = os.path.abspath(path)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore a checkpoint into the structure of `like` (a pytree with
    the right shapes/dtypes, e.g. the freshly-initialized state)."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(os.path.abspath(path)) as z:
        if len(z.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(z.files)} arrays, "
                f"expected {len(leaves)}"
            )
        new = []
        for i, ref in enumerate(leaves):
            x = z[f"leaf_{i}"]
            if x.shape != np.shape(ref):
                raise ValueError(
                    f"checkpoint {path}: leaf {i} has shape {x.shape}, "
                    f"expected {np.shape(ref)}"
                )
            new.append(x.astype(np.asarray(ref).dtype, copy=False))
    return jax.tree_util.tree_unflatten(treedef, new)


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(path)
