"""Sharded, step-atomic checkpoint store.

The PyTorch counterpart of ``src/repro/checkpoint/store.py``, with its
layout (one directory per step)::

    <dir>/step_000042/
        shard_00000.npz ... shard_NNNNN.npz   # leaves, round-robin by size
        MANIFEST.json                          # leaf path -> key and shard
    <dir>/COMMITTED_000042                     # atomic marker, written last

A tree is nested dicts (keys in sorted order, as JAX flattens a dict),
lists or tuples, with tensors, numpy arrays or Python scalars as leaves;
tensors are stored as numpy arrays (bfloat16 as float32), so the JAX
package's ``restore_checkpoint`` reads what this one writes.  The marker
is written after every shard has been fsync'd, so a crash mid-save never
corrupts the latest restorable step.  A restore puts each leaf back in the
type, dtype and device of the matching leaf of ``tree_like``.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _leaves(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def tree_map(fn, tree):
    """``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(x) -> np.ndarray:
    """A host copy of one leaf (a tensor leaves the card here), never a view:
    the caller may update the leaf in place once this returns."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _like(a: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
    if isinstance(like, bool):
        return bool(a)
    if isinstance(like, int):
        return int(a)
    if isinstance(like, float):
        return float(a)
    return a


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return _like(next(it), like)


def save_checkpoint(directory, step: int, tree, *, num_shards: int = 4) -> Path:
    directory = Path(directory)
    step_dir = directory / f"step_{step:06d}"
    step_dir.mkdir(parents=True, exist_ok=True)
    pairs = list(_leaves(tree))
    paths = ["/".join(p) for p, _ in pairs]
    arrays = [to_numpy(leaf) for _, leaf in pairs]

    # round-robin by descending size for balanced shards
    order = sorted(range(len(arrays)), key=lambda i: -arrays[i].nbytes)
    assign: dict[int, int] = {}
    sizes = [0] * num_shards
    for i in order:
        s = sizes.index(min(sizes))
        assign[i] = s
        sizes[s] += arrays[i].nbytes

    manifest = {"step": step, "leaves": []}
    for shard in range(num_shards):
        payload = {f"a{i}": arrays[i] for i in range(len(arrays))
                   if assign[i] == shard}
        f = step_dir / f"shard_{shard:05d}.npz"
        with open(f, "wb") as fh:
            np.savez(fh, **payload)
            fh.flush()
            os.fsync(fh.fileno())
    for i, p in enumerate(paths):
        manifest["leaves"].append({"path": p, "key": f"a{i}",
                                   "shard": assign[i]})
    mf = step_dir / "MANIFEST.json"
    mf.write_text(json.dumps(manifest))
    marker = directory / f"COMMITTED_{step:06d}"
    with open(marker, "w") as fh:
        fh.write("ok")
        fh.flush()
        os.fsync(fh.fileno())
    return step_dir


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("COMMITTED_*")]
    return max(steps) if steps else None


def restore_checkpoint(directory, tree_like, *, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``: each leaf takes the
    type, dtype and device of its counterpart there.

    Returns (step, tree) or (None, None) when no committed step exists.
    """
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None, None
    step_dir = directory / f"step_{step:06d}"
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    shards: dict[int, dict] = {}
    arrays: list[np.ndarray] = []
    for ent in manifest["leaves"]:
        s = ent["shard"]
        if s not in shards:
            shards[s] = np.load(step_dir / f"shard_{s:05d}.npz")
        arrays.append(shards[s][ent["key"]])
    n_like = sum(1 for _ in _leaves(tree_like))
    assert n_like == len(arrays), \
        f"checkpoint has {len(arrays)} leaves, target {n_like}"
    return step, _unflatten(tree_like, iter(arrays))


def prune_old(directory, keep: int = 3) -> None:
    directory = Path(directory)
    steps = sorted(int(p.name.split("_")[1])
                   for p in directory.glob("COMMITTED_*"))
    for s in steps[:-keep]:
        (directory / f"COMMITTED_{s:06d}").unlink(missing_ok=True)
        shutil.rmtree(directory / f"step_{s:06d}", ignore_errors=True)
