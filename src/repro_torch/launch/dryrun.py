"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes over fake tensors (no allocation).

The PyTorch counterpart of ``src/repro/launch/dryrun.py``.  Where the JAX
package lowers and compiles each step with ``ShapeDtypeStruct`` inputs,
the port runs the step once, eagerly, under a ``FakeTensorMode``: the
parameters, the ZeRO-1 moments, the batch and the caches are DTensors on a
``DeviceMesh`` of a fake process group (``launch/mesh.py``), placed by the
sharding rules, and their local shards are fake tensors of this card's
shapes.  For each cell this records, per card (``launch/costanalysis.py``):

  * FLOPs, HBM bytes, collective bytes and counts by type (and by link);
  * argument bytes (local params + moments + batch, or + cache) and temp
    bytes (the peak of the step's live storages): argument + temp is the
    predicted peak of the card's memory;
  * the DTensor-level ``FlopCounterMode`` total, which counts global FLOPs,
    as ``flops_rawhlo``, beside the per-card count.

``--device cuda`` (the default) makes fake CUDA tensors, so the kernels'
custom ops (B3 ``repro_torch::flash_attention_fwd``, B4
``repro_torch::ssd_scan_fwd``) are traced through their fake
implementations and sharding rules, launching nothing; ``--device cpu``
(the tests) traces the plain versions.  Plain tensors that a model makes
inside a step (positions, masks, RoPE tables) count as replicated
(``implicit_replication``).

Records are written as JSON under ``artifacts/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ALIASES, ARCHITECTURES, LONG_CONTEXT_OK,
                                 SHAPES, get_config)
from repro_torch.launch.costanalysis import CostMode
from repro_torch.launch.inputs import (cache_specs, decode_ids_specs,
                                       param_specs, train_batch_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim.adamw import zero1_shardings
from repro_torch.sharding import (batch_shardings, cache_shardings,
                                  param_shardings)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tensors)


def _place(t: torch.Tensor, sharding) -> torch.Tensor:
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def _place_params(model, shardings: dict, *, train: bool) -> dict:
    """Swap each parameter of ``model`` for a DTensor under its sharding;
    returns the new parameters by name."""
    for name, p in list(model.named_parameters()):
        path, _, leaf = name.rpartition(".")
        d = nn.Parameter(_place(p.detach(), shardings[name]),
                         requires_grad=train)
        model.get_submodule(path).register_parameter(leaf, d)
    return dict(model.named_parameters())


def _compile_one(cfg, shape_spec, mesh, *, zero1: bool = True,
                 device: str = "cuda"):
    """Trace one step program over fake DTensors; returns (stats, elapsed).

    ``stats`` holds :class:`CostMode`'s per-card counts, ``argument_bytes``
    and the DTensor-level ``flops_rawhlo``."""
    seq, gbs, kind = (shape_spec["seq_len"], shape_spec["global_batch"],
                      shape_spec["kind"])
    with FakeTensorMode(), implicit_replication():
        model, pspecs = param_specs(cfg, device=device)
        pshard = param_shardings(pspecs, mesh)
        params = _place_params(model, pshard, train=kind == "train")
        args = list(params.values())
        if kind == "train":
            oshard = (zero1_shardings(pspecs, mesh) if zero1
                      else {"m": pshard, "v": pshard})
            moments = {}
            for mv in ("m", "v"):
                moments[mv] = {
                    k: _place(torch.zeros(p.shape, dtype=torch.float32,
                                          device=device), oshard[mv][k])
                    for k, p in pspecs.items()}
                args += moments[mv].values()
            opt_state = {**moments, "step": 0}
            bspecs = train_batch_specs(cfg, gbs, seq, device=device)
            bshard = batch_shardings(bspecs, mesh)
            batch = {k: _place(v, bshard[k]) for k, v in bspecs.items()}
            args += batch.values()
            step = make_train_step(model)

            def run():
                return step(params, opt_state, batch)[2]
        elif kind == "prefill":
            bspecs = train_batch_specs(cfg, gbs, seq, device=device)
            bspecs.pop("labels")
            bshard = batch_shardings(bspecs, mesh)
            batch = {k: _place(v, bshard[k]) for k, v in bspecs.items()}
            args += batch.values()
            step = make_prefill_step(model, cfg, max_len=seq)

            def run():
                with torch.no_grad():
                    return step(batch)
        else:  # decode
            cspecs = cache_specs(cfg, gbs, seq, device=device)
            cshard = cache_shardings(cspecs, mesh)
            cache = {k: _place(v, cshard[k]) if k in cshard else v
                     for k, v in cspecs.items()}
            ids_spec = decode_ids_specs(gbs, device=device)
            ids = _place(ids_spec, batch_shardings(ids_spec, mesh))
            args += [v for k, v in cache.items() if k in cshard] + [ids]
            step = make_decode_step(model, cfg)
            extra = ()
            if cfg.family == "audio":
                enc = torch.empty((gbs, cfg.enc_frames, cfg.d_model),
                                  dtype=cfg.adt, device=device)
                extra = (_place(enc, batch_shardings(enc, mesh)),)
                args += extra

            def run():
                with torch.no_grad():
                    return step(cache, ids, *extra)

        argument_bytes = _local_bytes(args)
        t0 = time.time()
        with CostMode() as cost, FlopCounterMode(display=False) as raw:
            out = run()
        del out
        dt = time.time() - t0
    stats = cost.result()
    stats["argument_bytes"] = argument_bytes
    stats["flops_rawhlo"] = float(raw.get_total_flops())
    return stats, dt


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               zero1: bool = True, cfg=None, device: str = "cuda",
               mesh=None, spec: dict | None = None):
    """Trace one (arch x shape x mesh) cell; returns the record.

    ``mesh`` (default: the production mesh) and ``spec`` (default:
    ``SHAPES[shape]``) let a caller trace a cell of its own, such as the
    card check's (1, 1) step."""
    cfg = cfg or get_config(arch)
    spec = spec or SHAPES[shape]
    seq, gbs, kind = spec["seq_len"], spec["global_batch"], spec["kind"]

    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if shape == "long_500k" and mod_name not in LONG_CONTEXT_OK:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "skipped": "full-attention arch; O(seq) KV cache infeasible "
                           "at 500k (DESIGN.md §Arch-applicability)"}

    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device=device)
    nchips = math.prod(mesh.shape)
    stats, dt = _compile_one(cfg, spec, mesh, zero1=zero1, device=device)

    return {
        "arch": arch, "shape": shape,
        "multi_pod": multi_pod, "chips": nchips,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "seq_len": seq, "global_batch": gbs, "kind": kind,
        "trace_s": round(dt, 1),
        # per-card totals
        "flops": stats["flops"],
        "bytes_accessed": stats["bytes"],
        "collectives": stats["coll"],
        "collective_counts": stats["coll_count"],
        "collective_links": stats["coll_link"],
        "flops_rawhlo": stats["flops_rawhlo"],
        "memory": {
            "argument_bytes": stats["argument_bytes"],
            "output_bytes": stats["output_bytes"],
            "temp_bytes": stats["temp_bytes"],
            "generated_code_bytes": 0,
        },
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path, *,
             device: str = "cuda") -> dict:
    tag = "multi" if multi_pod else "single"
    out = out_dir / f"{arch}__{shape}__{tag}.json"
    try:
        rec = lower_cell(arch, shape, multi_pod=multi_pod, device=device)
    except Exception as e:  # noqa: BLE001 — recorded as cell failure
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "error": f"{type(e).__name__}: {e}"}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    status = ("SKIP" if "skipped" in rec else
              "FAIL" if "error" in rec else "ok")
    print(f"[dryrun] {arch:24s} {shape:12s} {tag:6s} {status}"
          + (f" trace={rec.get('trace_s')}s flops={rec.get('flops', 0):.3e}"
             if status == "ok" else "")
          + (f" :: {rec['error'][:120]}" if status == "FAIL" else ""),
          flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (the kernels' "
                         "custom ops) or cpu (their plain versions)")
    args = ap.parse_args()
    out_dir = Path(args.out)

    cells: list[tuple[str, str, bool]] = []
    archs = ARCHITECTURES if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))

    failures = 0
    t0 = time.time()
    for a, s, m in cells:
        rec = run_cell(a, s, m, out_dir, device=args.device)
        if "error" in rec:
            failures += 1
    print(f"[dryrun] done: {len(cells)} cells, {failures} failures, "
          f"{time.time() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
