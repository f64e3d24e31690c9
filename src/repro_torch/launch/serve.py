"""Serving entry point of the port.

``--engine model`` runs the continuous-batching-lite ServeLoop: requests are
packed into slot batches, prefilled once, decoded in lock-step; finished
slots refill from the queue.  Weights are drawn from a seed.  ``--arch``
takes the dense configs (qwen2-1.5b, h2o-danube-1.8b, starcoder2-3b,
minitron-4b), mamba2-370m and zamba2-7b.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --max-new 16 [--full] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --full

The JAX package's ``--engine scheduler`` needs the serving runtime
(``core/memo.py``), which is not ported yet (ROADMAP A11).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np


def _main_model(args: argparse.Namespace) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime import ServeLoop

    cfg = get_config(args.arch, reduced=not args.full)
    sl = ServeLoop(cfg, max_batch=args.max_batch, max_len=256,
                   device=args.device)
    rng = np.random.default_rng(0)
    reqs = [sl.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                      max_new=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    sl.run_until_idle()
    if sl.device.type == "cuda":
        torch.cuda.synchronize(sl.device)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in reqs)
    print(f"[serve] {cfg.name}: {args.requests} requests, {tokens} tokens "
          f"in {wall:.2f}s ({tokens / wall:.1f} tok/s), "
          f"{sl.stats['batches']} batches, "
          f"{sl.stats['decode_steps']} decode steps on {sl.device.type}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.output}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("model",), default="model")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _main_model(args)


if __name__ == "__main__":
    main()
