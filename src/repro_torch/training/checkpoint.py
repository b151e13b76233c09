"""Atomic checkpoints with resume, in the JAX package's on-disk layout.

Layout: <dir>/step_<n>/ one leaf_<i>.npy per leaf of a nested dict of
arrays, in the order ``jax.tree`` flattens it (sorted keys at every level),
and an index.json manifest of each leaf's "/"-joined key, file, shape and
dtype; written to a .tmp dir then renamed (atomic on POSIX), so a crash
mid-write never corrupts the latest checkpoint.  ``latest_step`` and
``restore`` give checkpoint/restart; old steps are collected, keeping the
newest K.  Either package's ``restore`` reads the other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key, leaf) pairs of a nested dict in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(_flatten(tree[key], f"{prefix}/{key}" if prefix
                            else str(key)))
    return out


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Atomically write one checkpoint; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree):
    """The checkpoint's arrays in the structure of ``like_tree`` (a nested
    dict whose leaves are only counted and placed)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        manifest = json.load(f)
    arrays = [np.load(os.path.join(path, leaf["file"]))
              for leaf in manifest["leaves"]]
    keys = [key for key, _ in _flatten(like_tree)]
    if len(keys) != len(arrays):
        raise ValueError(f"checkpoint {path} has {len(arrays)} leaves, the "
                         f"tree {len(keys)}")
    out: dict = {}
    for key, arr in zip(keys, arrays):
        *heads, last = key.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return out
