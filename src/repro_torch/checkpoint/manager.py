"""Checkpoint manager: interval policy, async save thread, retention,
restore-or-init with resharding.

The PyTorch counterpart of ``src/repro/checkpoint/manager.py``.
``save`` copies the tree's tensors to host numpy arrays (off the card)
before it hands the disk write to a background thread, so the training
loop may update the tensors in place at once; it blocks only if a previous
save is still in flight (bounded staleness of one).  ``restore_or_init``
with ``shardings`` places each tensor of the tree on a ``DeviceMesh`` with
``distribute_tensor``.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.distributed.tensor import distribute_tensor

from .store import (latest_step, prune_old, restore_checkpoint,
                    save_checkpoint, to_numpy, tree_map)


class CheckpointManager:
    def __init__(self, directory, *, interval: int = 100, keep: int = 3,
                 num_shards: int = 4, async_save: bool = True):
        self.directory = Path(directory)
        self.interval = interval
        self.keep = keep
        self.num_shards = num_shards
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves = 0

    # -- save ----------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> Optional[BaseException]:
        """Join any in-flight async save without raising.

        Fault-triggered teardown must not orphan the save thread — a
        half-written checkpoint racing the next grid's restore — nor mask
        the original failure with a save error.  Returns the pending save
        error (if any) and clears it; the manager stays usable.
        """
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        return err

    def save(self, step: int, tree) -> None:
        # snapshot to host BEFORE going async: the loop updates the tensors
        # in place after this returns
        host_tree = tree_map(to_numpy, tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                num_shards=self.num_shards)
                prune_old(self.directory, keep=self.keep)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self.wait()
        self.saves += 1
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    # -- restore ---------------------------------------------------------------
    def restore_or_init(self, init_fn: Callable[[], object], *,
                        shardings=None):
        """Restore the latest step into the structure, types and devices of
        ``init_fn()``'s tree, or return that tree.  Returns (step, tree).

        ``shardings`` is a tree of the same structure whose leaves are
        ``sharding.partition.NamedSharding`` (or None to leave a leaf as
        it is): each restored or fresh tensor then goes through
        ``distribute_tensor(t, mesh, placements)``."""
        like = init_fn()
        step, tree = restore_checkpoint(self.directory, like)
        if step is None:
            step, tree = 0, like
        if shardings is not None:
            tree = _place(tree, shardings)
        return step, tree

    @property
    def latest(self) -> Optional[int]:
        return latest_step(self.directory)


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) if k in shardings else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    if shardings is None or not isinstance(tree, torch.Tensor):
        return tree
    return distribute_tensor(tree, shardings.mesh, shardings.placements)
