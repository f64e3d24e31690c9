"""Serving entry points of the port.

Two engines share this entry point, both on the CUDA card unless
``--device cpu`` is given (without a card the default raises).

``--engine model`` (default) runs the continuous-batching-lite ServeLoop: requests are
packed into slot batches, prefilled once, decoded in lock-step; finished
slots refill from the queue.  Weights are drawn from a seed.  ``--arch``
takes the dense configs (qwen2-1.5b, h2o-danube-1.8b, starcoder2-3b,
minitron-4b), the MoE configs (granite-moe-1b-a400m, granite-moe-3b-a800m),
mamba2-370m and zamba2-7b; whisper-tiny and internvl2-26b take more than
tokens, so they are served through ``launch.steps``, not here.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --max-new 16 [--full] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --full

``--engine scheduler`` runs the persistent multi-tenant ServingRuntime
(``core/memo.py``): each tenant submits identical task windows in a loop
from its own client thread; the first few lower cold through
TDAG->CDAG->IDAG, the rest replay the memoized instruction window.  Each
tenant's buffer is bumped by one per window, which the run checks at the
end.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine scheduler \
        --tenants 4 --windows 50 --nodes 2 --devices 1 [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
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


def _main_scheduler(args: argparse.Namespace) -> None:
    from repro_torch.core import ServingRuntime, one_to_one, read_write

    w = args.width

    def kernel(chunk, v):
        v.set(chunk, v.get(chunk) + 1.0)

    with ServingRuntime(args.nodes, args.devices, device=args.device,
                        memo=not args.no_memo) as srv:
        tenants = [srv.tenant(f"t{i}") for i in range(args.tenants)]
        # read_write on an uninitialized region is undefined: seed zeros
        bufs = [t.buffer((w,), init=np.zeros(w), name="x") for t in tenants]

        def window(t, buf):
            t.submit("bump", (w,), [read_write(buf, one_to_one())], kernel)
            return t.run()

        lat_us: list[list[float]] = [[] for _ in tenants]

        def client(slot: int) -> None:
            t, buf = tenants[slot], bufs[slot]
            for _ in range(args.windows):
                t0 = time.perf_counter()
                window(t, buf).wait()
                lat_us[slot].append((time.perf_counter() - t0) * 1e6)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.tenants)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0

        total = args.tenants * args.windows
        if sum(map(len, lat_us)) != total:
            raise SystemExit("a client thread failed before its last window")
        flat = sorted(x for xs in lat_us for x in xs)
        p50 = flat[len(flat) // 2]
        p99 = flat[min(len(flat) - 1, int(len(flat) * 0.99))]
        stats = srv.memo_stats()
        print(f"[serve.scheduler] {args.tenants} tenant(s) x "
              f"{args.windows} windows on {args.nodes}x{args.devices} "
              f"({srv.device.type}): {total / wall:.0f} req/s, "
              f"p50 {p50:.0f}us, p99 {p99:.0f}us")
        print(f"  memo: hits={stats['hits']} misses={stats['misses']} "
              f"unreplayable={stats['unreplayable']}")
        for name in sorted(stats["tenants"]):
            ts = stats["tenants"][name]
            print(f"  {name}: lowered={ts['lowered']} "
                  f"replayed={ts['replayed']} done={ts['done']}")
        for t, buf in zip(tenants, bufs):
            got = t.gather(buf)
            expect = float(args.windows)
            if not np.array_equal(got, np.full(w, expect)):
                raise SystemExit(
                    f"result mismatch for {t.name}: {got[:4]} != {expect}")
        print(f"  results verified: every element == {args.windows:.1f}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("model", "scheduler"),
                    default="model")
    ap.add_argument("--device", default="cuda")
    # model engine
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--full", action="store_true")
    # scheduler engine
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--windows", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--no-memo", action="store_true")
    args = ap.parse_args(argv)
    if args.engine == "scheduler":
        _main_scheduler(args)
    else:
        _main_model(args)


if __name__ == "__main__":
    main()
