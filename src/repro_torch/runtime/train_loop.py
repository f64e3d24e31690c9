"""Macro-scale training loop, orchestrated by the port's IDAG machinery.

The PyTorch counterpart of ``src/repro/runtime/train_loop.py``.  The
instruction-graph runtime from ``repro_torch.core`` schedules the host-side
stages of each training step, as the JAX loop does with ``repro.core``:
data prefetch into a staging ring, the train step, and asynchronous
checkpoint I/O, as host tasks over virtual buffers:

  * ``stage[t % depth]``   written by prefetch task t, read by step task t —
    the WAR hazard between step t and prefetch t+depth is exactly the ring
    dependency the TDAG derives from the accessors;
  * checkpoint tasks read a ``ckpt_token`` buffer that step tasks write,
    serializing snapshots against parameter updates without blocking
    subsequent steps (the save itself is async in CheckpointManager).

The model and the optimizer state live on ``device``, the card unless the
caller asks for the CPU; the step task moves its batch there, with the
audio family's ``frames`` and the vlm family's ``vis`` (f32; the model casts
them).  Every family of the model zoo trains.  A state is
``{"params": the model's parameters by name, "opt": adamw state}``; the
step updates both in place.
"""

from __future__ import annotations

import queue as _queue
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (Box, Runtime, fixed, one_to_one, read,
                              read_write, write)
from repro_torch.core.task_graph import TaskType
from repro_torch.data import SyntheticLMData
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init


@dataclass
class TrainMetrics:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    restarts: int = 0
    grad_norms: list = field(default_factory=list)

    def log(self, step, loss, grad_norm=None):
        self.steps.append(int(step))
        self.losses.append(float(loss))
        if grad_norm is not None:
            self.grad_norms.append(float(grad_norm))


class TrainLoop:
    """``init``, when given, returns a model of ``cfg`` holding the initial
    weights on ``device`` (for example the JAX package's, through
    ``models.convert.model_from_numpy``); otherwise ``init_state`` draws
    them from ``seed`` on ``device``."""

    def __init__(self, cfg, *, global_batch: int, seq_len: int,
                 ckpt_dir=None, ckpt_interval: int = 50, lr: float = 3e-4,
                 prefetch_depth: int = 2, seed: int = 0, device="cuda",
                 init: Optional[Callable[[], torch.nn.Module]] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainLoop(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to train on the host")
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.model = None
        self._init = init
        self.data = SyntheticLMData(cfg, global_batch, seq_len, seed=seed)
        self.depth = prefetch_depth
        self.lr = lr
        self.ckpt = (CheckpointManager(ckpt_dir, interval=ckpt_interval)
                     if ckpt_dir else None)
        self.overlap = 0.0

    # -- state ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Fresh weights in ``self.model`` (trainable) and zero moments."""
        if self._init is not None:
            model = self._init()
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model = build_model(self.cfg).init(gen)
        self.model = model.requires_grad_(True)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": adamw_init(params)}

    def restore_or_init(self):
        """Checkpoints are taken AFTER step t completes, so a restore from
        step t resumes at t+1.  Restored weights are copied into the
        model's parameters, on their device."""
        if self.ckpt is not None and self.ckpt.latest is not None:
            step, state = self.ckpt.restore_or_init(lambda: self.init_state())
            params = dict(self.model.named_parameters())
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(state["params"][k])
            return step + 1, {"params": params, "opt": state["opt"]}
        return 0, self.init_state()

    # -- the IDAG-orchestrated run ------------------------------------------------
    def run(self, num_steps: int, *, start_step: Optional[int] = None,
            state=None, metrics: Optional[TrainMetrics] = None,
            fail_at: Optional[int] = None) -> tuple[int, dict, TrainMetrics]:
        """``state`` must come from this loop's ``init_state`` or
        ``restore_or_init`` (its params are the model's)."""
        metrics = metrics or TrainMetrics()
        if state is None:
            start_step, state = self.restore_or_init()
        assert start_step is not None
        holder = {"state": state}
        results: "_queue.SimpleQueue" = _queue.SimpleQueue()

        try:
            self._run_body(num_steps, start_step, holder, results, fail_at)
        finally:
            # drain metrics and finish in-flight checkpoint I/O even on the
            # failure path — a committed step must be restorable immediately
            while True:
                try:
                    metrics.log(*results.get_nowait())
                except _queue.Empty:
                    break
            if self.ckpt is not None:
                self.ckpt.wait()
        return start_step + num_steps, holder["state"], metrics

    def _run_body(self, num_steps, start_step, holder, results, fail_at):
        train_step = make_train_step(self.model, lr=self.lr)
        with Runtime(num_nodes=1, devices_per_node=1, trace=True,
                     device=self.device.type) as rt:
            B = self.global_batch
            stage = rt.buffer((self.depth, B, self.seq_len), dtype=np.int32,
                              name="stage",
                              init=np.zeros((self.depth, B, self.seq_len),
                                            np.int32))
            token = rt.buffer((1,), name="ckpt_token", init=np.zeros(1))

            def slot_region(t):
                return Box((t % self.depth, 0, 0),
                           (t % self.depth + 1, B, self.seq_len))

            # frames or image features of step t's batch, from its prefetch
            # (which the step depends on through the stage buffer)
            extras = {}
            for t in range(start_step, start_step + num_steps):
                def prefetch(chunk, v, t=t):
                    batch = self.data.local_batch(t)
                    v.set(slot_region(t), batch.pop("tokens")[None])
                    batch.pop("labels")
                    extras[t] = batch

                rt.submit(f"prefetch{t}", (1,),
                          [write(stage, fixed(slot_region(t)))],
                          prefetch, ttype=TaskType.HOST)

                def step_fn(chunk, v, tok, t=t):
                    toks = v.get(slot_region(t))[0].to(self.device, copy=True)
                    if fail_at is not None and t == fail_at:
                        raise RuntimeError(f"injected failure at step {t}")
                    batch = {"tokens": toks, "labels": toks}
                    for k, a in extras.pop(t).items():
                        batch[k] = torch.from_numpy(a).to(self.device)
                    s = holder["state"]
                    p, o, m = train_step(s["params"], s["opt"], batch)
                    holder["state"] = {"params": p, "opt": o}
                    results.put((t, float(m["loss"]), float(m["grad_norm"])))
                    tok[0] = float(t)

                rt.submit(f"step{t}", (1,),
                          [read(stage, fixed(slot_region(t))),
                           read_write(token, one_to_one())],
                          step_fn, ttype=TaskType.HOST)

                if self.ckpt is not None and self.ckpt.should_save(t):
                    def ckpt_fn(chunk, tok, t=t):
                        self.ckpt.save(t, holder["state"])

                    rt.submit(f"ckpt{t}", (1,),
                              [read(token, one_to_one())],
                              ckpt_fn, ttype=TaskType.HOST)
            rt.sync(timeout=600)
            self.overlap = (rt.tracer.overlap_fraction("N0.host", "N0.host")
                            if rt.tracer else 0.0)


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir=None, **kw) -> TrainMetrics:
    loop = TrainLoop(cfg, global_batch=global_batch, seq_len=seq_len,
                     ckpt_dir=ckpt_dir, **kw)
    _, _, metrics = loop.run(steps)
    return metrics
