"""The port's dry-run (``launch/dryrun.py``, ``costanalysis.py``,
``perf.py``) on the CPU: the counterparts of ``tests/test_dryrun.py``'s
analyzer checks, per-card counts on fake meshes, the kernels' custom ops
over fake CUDA tensors, and the dry-run held against the JAX package's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 unmasked_pairs)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_plain,
                                          ssd_state_pass,
                                          ssd_state_pass_plain)
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf
from repro_torch.launch.costanalysis import CostMode, analyze
from repro_torch.launch.mesh import make_dev_mesh, make_mesh

ROOT = Path(__file__).resolve().parents[1]
TRAIN = dict(seq_len=256, global_batch=16, kind="train")


# -- the cost analysis on plain tensors ------------------------------------------
@pytest.mark.parametrize("n", [1, 4])
def test_analyzer_counts_matmul_chain(n):
    """Every matmul of a chain counts ``2 m k n``; the tanh counts none."""
    d = 64
    x, w = torch.randn(8, d), torch.randn(d, d)

    def chain(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x

    assert analyze(chain, x, w)["flops"] == n * 2 * 8 * d * d


def test_analyzer_bytes_reasonable():
    """Bytes cover inputs + outputs, and do not explode."""
    d = 512
    a = torch.randn(d, d)
    got = analyze(torch.matmul, a, a)["bytes"]
    io = 3 * d * d * 4
    assert io <= got <= 3 * io, (got, io)


def test_analyzer_temp_is_peak_of_live_storages():
    """Temps that die free their bytes: a chain of three outputs the size of
    ``x`` peaks at two live at once, and keeps the last as the output."""
    x = torch.randn(1024)
    nb = 1024 * 4

    def chain(x):
        y = x * 2
        z = y * 3
        del y
        return z * 4

    got = analyze(chain, x)
    assert got["temp_bytes"] == 2 * nb and got["output_bytes"] == nb


def test_analyzer_in_place_updates_of_arguments_add_no_temp():
    """An optimizer's in-place updates return their arguments, whose
    storages predate the step: they are not the step's temps."""
    p, g = torch.randn(256), torch.randn(256)

    def update(p, g):
        p.mul_(0.9).add_(g, alpha=0.1)
        return p

    got = analyze(update, p, g)
    assert got["temp_bytes"] == 0 and got["output_bytes"] == 0


def test_sharded_matmul_counts_per_card():
    """On a fake (16, 16) mesh a matmul sharded over rows (data) and columns
    (model) costs each card global / 256 FLOPs; a ``FlopCounterMode`` over
    the DTensor op counts the global figure."""
    mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 1536), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(1536, 8960), mesh,
                              [Replicate(), Shard(1)])
        # the DTensor-level counter above the local one, as the dry-run
        # stacks them (below it, it would see the local op as well)
        with CostMode() as cost, FlopCounterMode(display=False) as fc:
            torch.matmul(x, w)
    got = cost.result()
    glob = 2 * 4096 * 1536 * 8960
    assert got["flops"] == glob / 256
    assert fc.get_total_flops() == glob
    assert not got["coll"]


def test_redistribute_counts_collective_bytes_and_link():
    """A ``Partial`` to ``Replicate`` redistribution is one all-reduce of the
    local bytes; a 16-card group spans two NVLink domains of 8."""
    from torch.distributed.tensor import Partial
    mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
    with FakeTensorMode():
        t = torch.empty(64, 32)
        d = DTensor.from_local(t, mesh, [Replicate(), Partial()])
        got = analyze(lambda d: d.redistribute(mesh, [Replicate(),
                                                      Replicate()]), d)
    assert got["coll"] == {"all-reduce": 64 * 32 * 4}
    assert got["coll_count"] == {"all-reduce": 1}
    assert got["coll_link"] == {"inter_node": 64 * 32 * 4}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    with FakeTensorMode():
        d = DTensor.from_local(torch.empty(8), mesh, [Replicate(), Partial()])
        got = analyze(lambda d: d.redistribute(mesh, [Replicate()] * 2), d)
    assert got["coll_link"] == {"nvlink": 32}


# -- the kernels' custom ops over fake CUDA tensors ------------------------------
def _cuda_like(t, dtype=None):
    return torch.empty(t.shape, dtype=dtype or t.dtype, device="cuda")


@pytest.mark.parametrize("B,S,T,K,G,hd,causal,window", [
    (2, 96, 96, 2, 3, 32, True, None),
    (1, 64, 200, 1, 4, 16, True, 40),
    (2, 48, 80, 2, 1, 8, False, None),
])
def test_flash_custom_op_on_fake_cuda(B, S, T, K, G, hd, causal, window):
    """Fake CUDA tensors reach ``repro_torch::flash_attention_fwd``, whose
    fake implementation gives the plain version's shapes and dtypes and
    launches nothing.

    Its flop formula counts ``4 B H hd`` per unmasked (query, key) pair, as
    PERF.md's bound counts B3's work.  The plain version computes every
    pair of its blocks, masked or not, so ``FlopCounterMode`` counts it at
    ``4 B H hd S T``: the formula equals that count scaled by the share of
    pairs the mask keeps, the pairs counted from an explicit mask."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, K, G, hd, generator=g)
    k = torch.randn(B, T, K, hd, generator=g)
    with FlopCounterMode(display=False) as fc:
        out, lse = flash_attention_plain(q, k, k, causal=causal, window=window,
                                         return_lse=True)
    n0 = flash_attention.launches
    with FakeTensorMode():
        with FlopCounterMode(display=False) as fk:
            fo, fl = flash_attention(_cuda_like(q), _cuda_like(k),
                                     _cuda_like(k), causal=causal,
                                     window=window, return_lse=True)
    assert flash_attention.launches == n0
    assert fo.device.type == "cuda"
    assert (fo.shape, fo.dtype, fl.shape, fl.dtype) == (
        out.shape, out.dtype, lse.shape, lse.dtype)
    pos = torch.arange(S)[:, None]
    key = torch.arange(T)[None, :]
    mask = key <= pos if causal else torch.ones(S, T, dtype=torch.bool)
    if window:
        mask &= key > pos - window
    pairs = int(mask.sum())
    assert unmasked_pairs(S, T, causal, window or 0, 0) == pairs
    assert fk.get_total_flops() == fc.get_total_flops() * pairs // (S * T)
    assert fc.get_total_flops() == 4 * B * K * G * hd * S * T


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 256, 4, 64, 16, 64),
                                             (1, 100, 3, 16, 8, 32)])
def test_ssd_custom_op_on_fake_cuda(b, s, h, p, n, chunk):
    """Fake CUDA tensors reach ``repro_torch::ssd_scan_fwd``: the plain
    version's shapes and dtypes, no launch, and its flop formula equals
    ``FlopCounterMode``'s count of the plain version at the same shapes."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, h, p, generator=g)
    a = -torch.rand(b, s, h, generator=g)
    B = torch.randn(b, s, n, generator=g)
    with FlopCounterMode(display=False) as fc:
        y, st = ssd_scan_plain(x, a, B, B, chunk)
    n0 = ssd_scan.launches
    with FakeTensorMode():
        with FlopCounterMode(display=False) as fk:
            fy, fs = ssd_scan(_cuda_like(x, torch.bfloat16), _cuda_like(a),
                              _cuda_like(B, torch.bfloat16),
                              _cuda_like(B, torch.bfloat16), chunk)
    assert ssd_scan.launches == n0
    assert (fy.shape, fs.shape, fs.dtype) == (y.shape, st.shape, st.dtype)
    assert fy.dtype == torch.bfloat16 and fy.device.type == "cuda"
    assert fk.get_total_flops() == fc.get_total_flops() > 0


def test_custom_op_sharding_rules():
    """On a fake (4, 4) mesh the custom ops keep their inputs' batch shards
    and, where every mesh dim divides the KV heads, B3 its head shards;
    ``lse`` ``[B,K,G,S]`` is sharded on dim 1 where ``out`` is on dim 2.
    B4 keeps head shards of ``x`` and ``a`` (``state`` on its dim 1)."""
    mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
    op = torch.ops.repro_torch.flash_attention_fwd
    with FakeTensorMode():
        for K, pl in ((4, [Shard(0), Shard(2)]), (2, [Shard(0), Replicate()])):
            q = distribute_tensor(torch.empty(8, 16, K, 2, 32), mesh, pl)
            k = distribute_tensor(torch.empty(8, 16, K, 32), mesh, pl)
            out, lse = op(q, k, k, True, 0, 0, True)
            assert list(out.placements) == pl
            assert list(lse.placements) == [p if not p.is_shard(2) else
                                            Shard(1) for p in pl]
            assert tuple(out.to_local().shape) == (2, 16, K // (4 if K == 4
                                                            else 1), 2, 32)
        bp = [Shard(0), Replicate()]
        x = distribute_tensor(torch.empty(8, 64, 4, 16), mesh, bp)
        a = distribute_tensor(torch.empty(8, 64, 4), mesh, bp)
        B = distribute_tensor(torch.empty(8, 64, 8), mesh, bp)
        y, st = torch.ops.repro_torch.ssd_scan_fwd(x, a, B, B, 32)
        assert list(y.placements) == bp and list(st.placements) == bp
        assert tuple(st.to_local().shape) == (2, 4, 16, 8)
        # heads over model: x and a on their head dim, B and C replicated
        hp = [Shard(0), Shard(2)]
        x = distribute_tensor(torch.empty(8, 64, 4, 16), mesh, hp)
        a = distribute_tensor(torch.empty(8, 64, 4), mesh, hp)
        y, st = torch.ops.repro_torch.ssd_scan_fwd(x, a, B, B, 32)
        assert list(y.placements) == hp
        assert list(st.placements) == [Shard(0), Shard(1)]
        assert tuple(st.to_local().shape) == (2, 1, 16, 8)


@pytest.mark.parametrize("b,c,h,p,n", [(2, 128, 4, 64, 16), (1, 1, 3, 5, 3)])
def test_state_pass_custom_ops_on_fake_cuda(b, c, h, p, n):
    """Fake CUDA tensors reach ``repro_torch::ssd_state_pass_fwd`` through
    ``ssd_state_pass`` and ``_bwd`` with and without each gradient: the
    plain version's shapes and dtypes, no launch."""
    g = torch.Generator().manual_seed(2)
    states = torch.randn(b, c, h, p, n, generator=g)
    decay = torch.rand(b, c, h, generator=g)
    hprev, hlast = ssd_state_pass_plain(states, decay)
    n0 = ssd_state_pass.launches
    with FakeTensorMode():
        fp, fl = ssd_state_pass(_cuda_like(states), _cuda_like(decay))
        grads = [torch.ops.repro_torch.ssd_state_pass_bwd(
            _cuda_like(decay), fp, dp, dl)
            for dp, dl in ((fp, fl), (fp, None), (None, fl))]
    assert ssd_state_pass.launches == n0
    for got, want in ((fp, hprev), (fl, hlast)):
        assert got.device.type == "cuda"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    for ds, dd in grads:
        assert (ds.shape, ds.dtype, ds.device.type) == (
            states.shape, torch.float32, "cuda")
        assert (dd.shape, dd.dtype) == (decay.shape, torch.float32)


@pytest.mark.parametrize("split", ["batch", "heads"])
def test_state_pass_sharding_rules(split):
    """On a fake (4, 4) mesh both ops keep a batch shard (dim 0 of every
    tensor) or a head shard (dim 2; ``hlast`` and its gradient on dim 1),
    with either gradient missing."""
    mesh = make_mesh((4, 4), ("data", "model"), device="cpu")
    pl = [Shard(0), Replicate() if split == "batch" else Shard(2)]
    last = [Shard(1) if p == Shard(2) else p for p in pl]
    local_h = 4 // (4 if split == "heads" else 1)
    with FakeTensorMode():
        states = distribute_tensor(torch.empty(8, 5, 4, 2, 3), mesh, pl)
        decay = distribute_tensor(torch.empty(8, 5, 4), mesh, pl)
        hprev, hlast = torch.ops.repro_torch.ssd_state_pass_fwd(states, decay)
        assert list(hprev.placements) == pl
        assert list(hlast.placements) == last
        assert tuple(hlast.to_local().shape) == (2, local_h, 2, 3)
        dhlast = distribute_tensor(torch.empty(8, 4, 2, 3), mesh, last)
        for dp, dl in ((hprev, dhlast), (hprev, None), (None, dhlast)):
            ds, dd = torch.ops.repro_torch.ssd_state_pass_bwd(decay, hprev,
                                                              dp, dl)
            assert list(ds.placements) == pl and list(dd.placements) == pl
            assert tuple(dd.to_local().shape) == (2, 5, local_h)


def test_direct_launch_only_for_plain_unwatched_tensors():
    """A kernel is called directly (no custom op dispatch) only for plain
    tensors with no dispatch mode active: fake tensors, DTensors and a
    ``FlopCounterMode`` over the call all take the op, where the fake
    implementation, the sharding rule and the flop formula see it."""
    from repro_torch.kernels import _build
    t = torch.empty(4)
    assert _build.direct(t, t)
    with FlopCounterMode(display=False):
        assert not _build.direct(t)
    with FakeTensorMode():
        assert not _build.direct(torch.empty(4))
    mesh = make_dev_mesh(1, 1, device="cpu")
    assert not _build.direct(t, distribute_tensor(t, mesh, [Replicate()] * 2))


# -- the dry-run ------------------------------------------------------------------
DRYRUN_SNIPPET = r"""
import json
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.configs import get_config
import repro_torch.launch.mesh as M

# shrink the production mesh for the test harness
def small_mesh(*, multi_pod=False, device="cuda"):
    return (make_mesh((2, 2, 4), ("pod", "data", "model"), device=device)
            if multi_pod else make_mesh((4, 4), ("data", "model"), device=device))
M.make_production_mesh = small_mesh
D.make_production_mesh = small_mesh
D.SHAPES["train_4k"] = dict(seq_len=256, global_batch=16, kind="train")

cfg = get_config("qwen2_1_5b", reduced=True)
rec = D.lower_cell("qwen2_1_5b", "train_4k", multi_pod=False, cfg=cfg,
                   device="cpu")
rec2 = D.lower_cell("qwen2_1_5b", "train_4k", multi_pod=True, cfg=cfg,
                    device="cpu")
assert rec["flops"] > 0 and rec2["flops"] > 0
assert rec["chips"] == 16 and rec2["chips"] == 16
import sys
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
assert not bad, bad
print(json.dumps({"single": rec["flops"], "multi": rec2["flops"],
                  "mesh2": rec2["mesh"]}))
"""


def test_dryrun_subprocess_small_mesh():
    """``lower_cell`` of reduced qwen2-1.5b on fake (4, 4) and (2, 2, 4)
    meshes (16 cards each), loading neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", DRYRUN_SNIPPET], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["single"] > 0
    assert rec["mesh2"] == {"pod": 2, "data": 2, "model": 4}


JAX_FLOPS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
import numpy as np
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.launch.hloanalysis import analyze
from repro.launch.inputs import param_specs, train_batch_specs
from repro.optim.adamw import zero1_shardings
from repro.sharding import batch_shardings, param_shardings

spec = json.loads(sys.argv[1])
out = {"flops": {}}
mesh = jax.make_mesh((1, 1), ("data", "model"))
for arch in ("qwen2_1_5b", "granite_moe_1b_a400m", "mamba2_370m"):
    c, _ = D._compile_one(get_config(arch, reduced=True), spec, mesh)
    out["flops"][arch] = analyze(c.as_text())["flops"]

# per-card argument bytes on (4, 4): params, ZeRO-1 moments, batch
mesh = jax.make_mesh((4, 4), ("data", "model"))
c, _ = D._compile_one(get_config("mamba2_370m", reduced=True), spec, mesh)
out["flops_4x4"] = {"mamba2_370m": analyze(c.as_text())["flops"]}
cfg = get_config("qwen2_1_5b", reduced=True)
_, p = param_specs(cfg)
b = train_batch_specs(cfg, spec["global_batch"], spec["seq_len"])
z = zero1_shardings(p, mesh)
def nbytes(tree, shards):
    leaves = jax.tree.leaves(tree)
    sh = jax.tree.leaves(shards, is_leaf=lambda s: hasattr(s, "shard_shape"))
    return sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
               for l, s in zip(leaves, sh))
out["argument_bytes"] = (nbytes(p, param_shardings(p, mesh))
                         + 2 * nbytes(p, z["m"])
                         + nbytes(b, batch_shardings(b, mesh)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", JAX_FLOPS, json.dumps(TRAIN)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cell(arch, mesh):
    return D.lower_cell(arch, "train_4k", cfg=get_config(arch, reduced=True),
                        device="cpu", mesh=mesh, spec=TRAIN)


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "granite_moe_1b_a400m"])
def test_flops_at_1x1_match_jax(jax_reference, arch):
    """At (1, 1) the per-card FLOPs of a reduced training step (flash off,
    remat on) are within 5% of the JAX package's loop-aware HLO analysis
    of the same config and shape; a one-card mesh's DTensor count is the
    per-card count."""
    rec = _cell(arch, make_dev_mesh(1, 1, device="cpu"))
    exp = jax_reference["flops"][arch]
    assert abs(rec["flops"] - exp) / exp < 0.05, (rec["flops"], exp)
    assert rec["flops_rawhlo"] == rec["flops"]


def test_mamba2_flops_at_1x1_against_jax(jax_reference):
    """Reduced mamba2-370m at (1, 1), printed against the JAX analysis.  The
    HLO analyzer counts ``dot`` ops only (the depthwise conv is a
    convolution there, and no dot); the port counts every matmul-type op
    ``torch.utils.flop_counter`` knows, including the SSD scan's
    three-operand einsums, which torch contracts pairwise along another
    path than XLA's dots.  So the port counts somewhat more; the ratio is
    printed, and held only loosely (within 10%) so that a lost layer
    shows."""
    rec = _cell("mamba2_370m", make_dev_mesh(1, 1, device="cpu"))
    exp = jax_reference["flops"]["mamba2_370m"]
    ratio = rec["flops"] / exp
    print(f"mamba2-370m reduced, (1,1): port {rec['flops']:.6e}, "
          f"JAX {exp:.6e}, ratio {ratio:.4f}")
    assert 0.9 < ratio < 1.1


def test_mamba2_flops_on_4x4_against_jax(jax_reference):
    """Reduced mamba2-370m on a fake (4, 4) mesh: the layers are
    tensor-parallel over ``model`` (in_proj's z, x and dt columns, conv,
    SSD and the skip per head shard, out_proj's rows), so per card the
    step costs the (1, 1) step over 16, plus what every head shard
    computes whole: B and C, which all heads share, are projected on each
    card (the ``[D, 2n]`` columns of in_proj in the forward, its
    recomputation, and both backward products).  With that replication
    taken out, the port's (4, 4) count stands to the JAX analysis's as its
    (1, 1) count does (see ``test_mamba2_flops_at_1x1_against_jax``),
    within 2%."""
    cfg = get_config("mamba2_370m", reduced=True)
    one = _cell("mamba2_370m", make_dev_mesh(1, 1, device="cpu"))
    rec = _cell("mamba2_370m", make_mesh((4, 4), ("data", "model"),
                                         device="cpu"))
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"] // 4
    bc = 4 * 2 * tokens * cfg.d_model * 2 * cfg.ssm_state * cfg.num_layers
    replicated = bc * (1 - 1 / 4)
    jax11 = jax_reference["flops"]["mamba2_370m"]
    jax44 = jax_reference["flops_4x4"]["mamba2_370m"]
    ratio = (rec["flops"] - replicated) / jax44 / (one["flops"] / jax11)
    print(f"mamba2-370m reduced, (4,4): port {rec['flops']:.6e} "
          f"(B C replication {replicated:.4e}), JAX {jax44:.6e}, "
          f"(1,1) port/16 {one['flops'] / 16:.6e}, ratio {ratio:.4f}")
    assert abs(ratio - 1) < 0.02
    assert rec["flops"] < one["flops"] / 16 * 1.15


def test_argument_bytes_on_4x4_match_jax_shards(jax_reference):
    """Per-card argument bytes (params, ZeRO-1 ``m`` and ``v``, the batch)
    on (4, 4) equal the sum of the reference's ``shard_shape`` bytes.  The
    reference's optimizer ``step`` (an int32 scalar) is left out: the
    port's is a Python int."""
    rec = _cell("qwen2_1_5b", make_mesh((4, 4), ("data", "model"),
                                        device="cpu"))
    assert rec["memory"]["argument_bytes"] == jax_reference["argument_bytes"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_lower_cell_serving_steps(kind):
    """Prefill and decode cells trace on a fake (2, 4) mesh; a decode cell's
    arguments include its sharded cache."""
    spec = dict(seq_len=128, global_batch=8, kind=kind)
    rec = D.lower_cell("qwen2_1_5b", f"{kind}_32k",
                       cfg=get_config("qwen2_1_5b", reduced=True),
                       device="cpu", spec=spec,
                       mesh=make_mesh((2, 4), ("data", "model"), device="cpu"))
    assert rec["flops"] > 0 and rec["chips"] == 8 and rec["kind"] == kind
    assert rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flash_route_per_shard_on_cpu(kind):
    """With flash attention on, DTensors on the CPU run B3's plain version
    per shard of batch and KV heads (a fake (2, 2) mesh); at (1, 1) the
    trace's FLOPs equal a ``FlopCounterMode`` count of the same step run
    for real."""
    import dataclasses
    from repro_torch.launch.inputs import train_batch
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config("qwen2_1_5b", reduced=True),
                              flash_attention=True)
    spec = dict(seq_len=64, global_batch=4, kind=kind)
    rec = D.lower_cell("qwen2_1_5b", kind, cfg=cfg, device="cpu", spec=spec,
                       mesh=make_mesh((2, 2), ("data", "model"),
                                      device="cpu"))
    assert rec["flops"] > 0
    one = D.lower_cell("qwen2_1_5b", kind, cfg=cfg, device="cpu", spec=spec,
                       mesh=make_dev_mesh(1, 1, device="cpu"))
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = train_batch(cfg, 4, 64, device="cpu")
    if kind == "train":
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        step, opt = make_train_step(model), adamw_init(params)
        with FlopCounterMode(display=False) as fc:
            step(params, opt, batch)
    else:
        batch.pop("labels")
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            make_prefill_step(model, cfg, 64)(batch)
    assert one["flops"] == fc.get_total_flops()


def test_long_500k_skipped_for_full_attention():
    rec = D.lower_cell("qwen2_1_5b", "long_500k", device="cpu")
    assert "skipped" in rec and "flops" not in rec


def test_run_cell_writes_record(tmp_path, monkeypatch):
    """``run_cell`` writes its record (or the cell's error) under the given
    directory, never under ``artifacts/dryrun/``."""
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False, device="cuda":
                        make_mesh((2, 2), ("data", "model"), device=device))
    monkeypatch.setitem(D.SHAPES, "decode_32k",
                        dict(seq_len=64, global_batch=4, kind="decode"))
    monkeypatch.setattr(D, "get_config",
                        lambda arch: get_config(arch, reduced=True))
    rec = D.run_cell("mamba2_370m", "decode_32k", False, tmp_path,
                     device="cpu")
    assert "flops" in rec, rec
    path = tmp_path / "mamba2_370m__decode_32k__single.json"
    assert json.loads(path.read_text())["flops"] == rec["flops"]
    assert D.ART_DIR.name == "dryrun_torch"


# -- the roofline terms -------------------------------------------------------------
def test_perf_terms_on_a_reduced_cell():
    """``perf.terms`` of a traced reduced cell: the step time is the largest
    of the three terms, which names the dominant one, each the per-card
    count over the H100's rate for it; ``mfu`` as ``perf`` computes it."""
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = get_config("qwen2_1_5b", reduced=True)
    stats, _ = D._compile_one(cfg, TRAIN, mesh, device="cpu")
    t = perf.terms(stats, {"variant": "baseline"})
    assert t["compute"] == stats["flops"] / perf.PEAK
    assert t["memory"] == stats["bytes"] / perf.HBM
    # a 4-card model axis and a data axis of stride 4 stay inside one
    # 8-card NVLink domain
    assert set(stats["coll_link"]) == {"nvlink"}
    assert t["collective"] == pytest.approx(
        sum(stats["coll"].values()) / perf.NVLINK_BW)
    assert t["step_time"] == max(t["compute"], t["memory"], t["collective"])
    assert t[t["dominant"]] == t["step_time"]
    mflops = 6 * cfg.param_count(active_only=True) * 256 * 16
    mfu = mflops / (8 * perf.PEAK * t["step_time"])
    assert 0 < mfu < 1
    # the constants are the H100 SXM5's datasheet figures
    assert (perf.PEAK, perf.HBM) == (989.4e12, 3.35e12)


def test_flash_kernel_traffic_scales_with_layers():
    cfg = get_config("qwen2_1_5b")
    spec = {"global_batch": 256, "seq_len": 4096}
    one = perf._flash_kernel_traffic(cfg, spec, train=False)
    assert one > 0
    assert perf._flash_kernel_traffic(cfg, spec, train=True) > 2 * one
    assert perf._flash_kernel_traffic(get_config("mamba2_370m"), spec,
                                      train=True) == 0.0
