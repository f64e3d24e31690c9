"""Batched serving loop: continuous-batching-lite over a fixed slot grid.

The PyTorch counterpart of ``src/repro/runtime/serve_loop.py``.  Requests
enter a queue; the loop packs up to ``max_batch`` prompts, left-pads them
with token 0 (no padding mask, as in the JAX package), runs one prefill, then
decodes all slots in lock-step until every request has its ``max_new``
tokens.  The model runs on ``device``: the card by default, the CPU when
asked.
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models import build_model


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                     # [S] int32
    max_new: int = 16
    done: threading.Event = field(default_factory=threading.Event)
    output: list = field(default_factory=list)


class ServeLoop:
    """``model`` is a module built by ``build_model`` with its weights on
    ``device``; without one, weights are drawn from ``seed`` on ``device``."""

    def __init__(self, cfg, model: Optional[torch.nn.Module] = None, *,
                 max_batch: int = 4, max_len: int = 256, seed: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeLoop(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to serve on the host")
        if cfg.family in ("audio", "vlm"):
            raise ValueError(f"ServeLoop serves token prompts; the "
                             f"{cfg.family} family also needs "
                             f"{'frames' if cfg.family == 'audio' else 'vis'}"
                             " (see launch.steps)")
        self.cfg = cfg
        if model is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model = build_model(cfg).init(gen)
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # submit() is called from many client threads: itertools.count is
        # atomic under the GIL
        self._rids = itertools.count(1)
        self.stats = {"batches": 0, "decode_steps": 0, "requests": 0}

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        req = Request(next(self._rids), np.asarray(prompt, np.int32), max_new)
        self.queue.put(req)
        return req

    def _take_batch(self) -> list[Request]:
        # one request always, whatever max_batch says (as the reference does)
        out = []
        while not out or len(out) < self.max_batch:
            try:
                out.append(self.queue.get_nowait())
            except queue.Empty:
                break
        return out

    def run_until_idle(self) -> None:
        """Serve everything currently queued."""
        while True:
            reqs = self._take_batch()
            if not reqs:
                return
            self._serve_batch(reqs)

    @torch.inference_mode()
    def _serve_batch(self, reqs: list[Request]) -> None:
        self.stats["batches"] += 1
        self.stats["requests"] += len(reqs)
        B = len(reqs)
        # left-pad prompts to a common length with token 0
        S = max(len(r.prompt) for r in reqs)
        ids = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            ids[i, S - len(r.prompt):] = r.prompt
        logits, cache = self.model.prefill(
            torch.from_numpy(ids).to(self.device), max_len=self.max_len)
        tok = logits.argmax(-1)
        live = np.ones(B, bool)
        produced = np.zeros(B, np.int32)
        while live.any():
            host = tok.tolist()            # one wait on the card per step
            for i, r in enumerate(reqs):
                if live[i]:
                    r.output.append(host[i])
                    produced[i] += 1
                    if produced[i] >= r.max_new:
                        live[i] = False
                        r.done.set()
            if not live.any():
                break
            logits, cache = self.model.decode_step(cache, tok[:, None])
            tok = logits.argmax(-1)
            self.stats["decode_steps"] += 1
