"""Roofline variants of three cells on the H100's constants.

The PyTorch counterpart of ``src/repro/launch/perf.py``, with its cells:

  * qwen2_1_5b   x train_4k     -- the canonical 6ND train step
  * minitron_4b  x prefill_32k  -- the most collective-bound baseline
  * granite_moe_3b_a800m x train_4k -- the worst roofline fraction

For each cell the harness traces a sequence of variants (baseline first)
with the dry-run (``launch/dryrun.py``) on the single-pod mesh, or on the
variant's ``_mesh`` (data, model), and records three roofline terms per
variant into ``artifacts/perf_torch/<cell>.json``:

  * compute    = per-card FLOPs / ``PEAK_FLOPS_BF16``;
  * memory     = per-card eager HBM bytes / ``HBM_BW``;
  * collective = per-card collective bytes over the link each group uses:
                 ``NVLINK_BW`` for a group inside one NVLink domain of
                 ``NVLINK_DOMAIN`` cards, ``INTER_NODE_BW`` for one that
                 crosses nodes (on (16, 16) both axes cross nodes, so every
                 collective takes the inter-node link);

and ``mfu = model_flops / (chips * PEAK * step_time)`` with ``step_time``
the largest term.  The constants are the H100 SXM5 datasheet's
(``launch/mesh.py``), not measured.

Run: PYTHONPATH=src python -m repro_torch.launch.perf [--device cpu] [cell ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import _compile_one
from repro_torch.launch.mesh import (HBM_BW, INTER_NODE_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_mesh,
                                     make_production_mesh)

ART = Path(__file__).resolve().parents[3] / "artifacts" / "perf_torch"

PEAK, HBM = PEAK_FLOPS_BF16, HBM_BW
LINK_BW = {"nvlink": NVLINK_BW, "inter_node": INTER_NODE_BW}


def _dominant(c: float, m: float, n: float) -> str:
    return max(("compute", c), ("memory", m), ("collective", n),
               key=lambda kv: kv[1])[0]


def terms(stats: dict, rec_extra: dict) -> dict:
    coll = sum(stats["coll"].values())
    c, m = stats["flops"] / PEAK, stats["bytes"] / HBM
    n = sum(b / LINK_BW[link] for link, b in stats["coll_link"].items())
    step = max(c, m, n)
    return dict(compute=c, memory=m, collective=n, step_time=step,
                dominant=_dominant(c, m, n), flops=stats["flops"],
                bytes=stats["bytes"], coll_bytes=coll,
                coll_link=dict(stats["coll_link"]), **rec_extra)


def _flash_kernel_traffic(cfg, spec, *, train: bool, dp: int = 16) -> float:
    """Analytic per-card HBM traffic of a fused flash-attention kernel:
    q/k/v/o (+grads) cross HBM once per pass; block intermediates stay in
    shared memory and registers.  Used to project the kernel's memory term
    from the attention-ablated trace."""
    if cfg.num_heads == 0:
        return 0.0
    b_loc = spec["global_batch"] / dp
    S = spec["seq_len"]
    e = 2  # bf16
    q_sz = b_loc * S * cfg.num_heads * cfg.hd * e
    kv_sz = b_loc * S * cfg.num_kv_heads * cfg.hd * e
    lse = b_loc * S * cfg.num_heads * 4
    fwd = q_sz + 2 * kv_sz + q_sz + lse                  # r q,k,v; w o,lse
    bwd = (2 * q_sz + 2 * kv_sz + lse) + (q_sz + 2 * kv_sz)  # r + w grads
    per_layer = fwd + (fwd + bwd if train else 0.0)      # remat recompute
    n_attn = (cfg.num_layers if cfg.family in ("dense", "moe", "vlm")
              else cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.num_layers)
    return per_layer * n_attn


def run_variants(arch: str, shape: str, variants: list[tuple[str, dict]],
                 *, project_kernel_from: str | None = None,
                 device: str = "cuda"):
    spec = SHAPES[shape]
    base_cfg = get_config(arch)
    results = []
    model_flops = None

    def report(t):
        print(f"[perf] {arch}/{shape} {t['variant']:28s} "
              f"dom={t['dominant']:10s} step={t['step_time']:8.3f}s "
              f"c={t['compute']:.3f} m={t['memory']:.3f} "
              f"n={t['collective']:.3f} mfu={t['mfu']:.4f}", flush=True)

    def mesh_of(shape_dm):
        if shape_dm is None:
            return make_production_mesh(device=device)
        return make_mesh(tuple(shape_dm), ("data", "model"), device=device)

    for name, overrides in variants:
        overrides = dict(overrides)
        mesh_shape = overrides.pop("_mesh", None)
        vmesh = mesh_of(mesh_shape)
        cfg = dataclasses.replace(base_cfg, **overrides)
        t0 = time.time()
        stats, _ = _compile_one(cfg, spec, vmesh, device=device)
        if model_flops is None:
            # train: 6ND (fwd+bwd); prefill/decode: 2ND (fwd only)
            mult = 6 if spec["kind"] == "train" else 2
            D = (spec["seq_len"] * spec["global_batch"]
                 if spec["kind"] != "decode" else spec["global_batch"])
            model_flops = mult * cfg.param_count(active_only=True) * D
        chips = math.prod(vmesh.shape)
        t = terms(stats, {"variant": name, "overrides": overrides,
                          "mesh_shape": tuple(vmesh.shape), "chips": chips,
                          "trace_s": round(time.time() - t0, 1)})
        t["mfu"] = model_flops / (chips * PEAK * t["step_time"])
        results.append(t)
        report(t)

    if project_kernel_from is not None:
        # trace the attention-ablated variant -> non-attention floor, then
        # add the analytic fused-kernel traffic
        src = next(r for r in results if r["variant"] == project_kernel_from)
        cfg = dataclasses.replace(base_cfg, ablate_attention=True,
                                  **src["overrides"])
        floor, _ = _compile_one(cfg, spec, mesh_of(src["mesh_shape"]),
                                device=device)
        ktraffic = _flash_kernel_traffic(base_cfg, spec,
                                         train=spec["kind"] == "train",
                                         dp=src["mesh_shape"][0])
        m = (floor["bytes"] + ktraffic) / HBM
        c, n = src["compute"], src["collective"]
        step = max(c, m, n)
        t = dict(compute=c, memory=m, collective=n, step_time=step,
                 dominant=_dominant(c, m, n), flops=src["flops"],
                 bytes=floor["bytes"] + ktraffic,
                 coll_bytes=src["coll_bytes"], coll_link=src["coll_link"],
                 variant="+fused_kernel(projected)",
                 overrides={"note": "attention-ablated trace + analytic "
                                    "fused-kernel traffic"},
                 mesh_shape=src["mesh_shape"], chips=src["chips"],
                 mfu=model_flops / (src["chips"] * PEAK * step))
        results.append(t)
        report(t)

    ART.mkdir(parents=True, exist_ok=True)
    (ART / f"{arch}__{shape}.json").write_text(json.dumps(results, indent=1))
    return results


CELLS = {
    "qwen_train": lambda **kw: run_variants("qwen2_1_5b", "train_4k", [
        ("baseline", {}),
        ("+flash_attention", dict(flash_attention=True)),
        ("+bf16_params", dict(flash_attention=True, param_dtype="bfloat16")),
        ("+no_remat", dict(flash_attention=True, param_dtype="bfloat16",
                           remat=False)),
        ("+mesh_32x8", dict(flash_attention=True, param_dtype="bfloat16",
                            _mesh=(32, 8))),
        ("+mesh_64x4", dict(flash_attention=True, param_dtype="bfloat16",
                            _mesh=(64, 4))),
        ("+mesh_128x2", dict(flash_attention=True, param_dtype="bfloat16",
                             _mesh=(128, 2))),
        ("+mesh_256x1_pure_dp", dict(flash_attention=True,
                                     param_dtype="bfloat16", _mesh=(256, 1))),
    ], project_kernel_from="+mesh_128x2", **kw),
    "minitron_prefill": lambda **kw: run_variants("minitron_4b", "prefill_32k", [
        ("baseline", {}),
        ("+flash_attention", dict(flash_attention=True)),
        ("+bf16_params", dict(flash_attention=True, param_dtype="bfloat16")),
        ("+mesh_32x8", dict(flash_attention=True, param_dtype="bfloat16",
                            _mesh=(32, 8))),
    ], project_kernel_from="+mesh_32x8", **kw),
    "granite_train": lambda **kw: run_variants("granite_moe_3b_a800m", "train_4k", [
        ("baseline", {}),
        ("+flash_attention", dict(flash_attention=True)),
        ("+bf16_params", dict(flash_attention=True, param_dtype="bfloat16")),
        ("+moe_group_2048", dict(flash_attention=True,
                                 param_dtype="bfloat16", moe_group=2048)),
        ("+mesh_32x8_ep8", dict(flash_attention=True, param_dtype="bfloat16",
                                _mesh=(32, 8))),
        ("+mesh_64x4_ep4", dict(flash_attention=True, param_dtype="bfloat16",
                                _mesh=(64, 4))),
    ], project_kernel_from="+mesh_32x8_ep8", **kw),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=list(CELLS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for n in args.cells:
        CELLS[n](device=args.device)


if __name__ == "__main__":
    main()
