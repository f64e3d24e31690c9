# Copied from src/repro/data/pipeline.py, with its own D_VIS and imports from repro_torch.
"""Deterministic, shard-aware, resumable synthetic data pipeline.

Every batch is a pure function of ``(seed, step, dp_rank)`` — so a restart
from a checkpoint at step k, or an elastic reshard onto a different
data-parallel width, reproduces the exact token stream with no state to
persist beyond the step counter.

The ``Prefetcher`` runs the generator in a host thread with a bounded queue,
giving the compute/IO overlap the macro training loop schedules around.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from repro_torch.models.config import ArchConfig

D_VIS = 1024   # stub InternViT output width, as src/repro/models/internvl.py


class SyntheticLMData:
    """Synthetic power-law token stream with next-token labels."""

    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 *, seed: int = 0):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed

    def local_batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        assert self.global_batch % dp_size == 0
        lb = self.global_batch // dp_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, dp_rank]))
        # zipf-ish marginal over the vocab, cheap and deterministic
        v = self.cfg.vocab_size
        u = rng.random((lb, self.seq_len))
        toks = np.minimum((u ** 3 * v).astype(np.int32), v - 1)
        out = {"tokens": toks, "labels": toks}
        if self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (lb, self.cfg.enc_frames, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "vlm":
            out["vis"] = rng.standard_normal(
                (lb, self.cfg.vis_tokens, D_VIS)).astype(np.float32)
        return out


class Prefetcher:
    """Bounded-depth background prefetch of ``SyntheticLMData`` batches."""

    def __init__(self, data: SyntheticLMData, *, start_step: int = 0,
                 depth: int = 2, dp_rank: int = 0, dp_size: int = 1):
        self.data = data
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._dp = (dp_rank, dp_size)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.data.local_batch(step, *self._dp)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 30.0) -> tuple[int, dict]:
        return self._q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
