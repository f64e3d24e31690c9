"""Training driver of the port, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 100 --batch 8 --seq 128 [--full] [--flash] [--ckpt DIR] \
        [--device cpu]

The counterpart of ``src/repro/launch/train.py`` (and of
``examples/train_lm.py``): without ``--full`` it trains the reduced family
variant; ``--full`` takes the published config (f32 weights, bf16
activations); ``--flash`` sets ``flash_attention=True``, so every layer's
attention runs kernel B3 forward and the plain blockwise backward.  The loop
is the IDAG-orchestrated ``TrainLoop``: data prefetch, the step and async
checkpointing are host tasks of the port's runtime.  Every family trains
(``--arch`` takes any config of ``repro_torch.configs``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--flash", action="store_true",
                    help="flash attention (kernel B3) in every layer")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainLoop

    cfg = get_config(args.arch, reduced=not args.full)
    if args.flash:
        cfg = dataclasses.replace(cfg, flash_attention=True)
    print(f"[train] {cfg.name} ({'full' if args.full else 'reduced'}): "
          f"{cfg.param_count() / 1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq} device={args.device} "
          f"flash={cfg.flash_attention}")
    loop = TrainLoop(cfg, global_batch=args.batch, seq_len=args.seq,
                     ckpt_dir=args.ckpt, ckpt_interval=args.ckpt_interval,
                     lr=args.lr, device=args.device)
    t0 = time.perf_counter()
    end, _, m = loop.run(args.steps)
    if loop.device.type == "cuda":
        torch.cuda.synchronize(loop.device)
    wall = time.perf_counter() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"[train] {args.steps} steps in {wall:.1f}s "
          f"({wall / args.steps * 1e3:.0f} ms/step, "
          f"{tokens / wall:.0f} tokens/s, the first step included)")
    print(f"[train] loss {m.losses[0]:.4f} -> {m.losses[-1]:.4f}")


if __name__ == "__main__":
    main()
