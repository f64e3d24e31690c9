"""The models on DTensors, on values: two gloo processes on the CPU, meshes
(2, 1) and (1, 2), reduced configs in f32.

The dry-run traces the models over DTensors placed by the sharding rules,
and ``restore_or_init(shardings=)`` hands users such DTensors; the mends
that make the models run on them carry their own arithmetic (the
vocab-parallel cross entropy, the experts' partial sums, Mamba2's per-head
shards with B and C replicated, gradients settled at row-parallel outputs).
Here each is held against the plain model on the same weights and batch:
the loss and every parameter's gradient of a training step, and for
mamba2 a prefill and a decode step on a cache placed as the dry-run
places it.  Two processes make every collective real: (2, 1) splits the
batch, (1, 2) the vocab, the heads and the experts.

Tolerance: the sharded run sums partial results across the two ranks in
another order than the plain run, so values agree to f32 rounding;
each tensor's max abs error is held under ``1e-5 * (1 + max |plain|)``.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2_1_5b", "granite_moe_1b_a400m", "mamba2_370m", "zamba2_7b"]
TOL = 1e-5

SNIPPET = r"""
import json, sys
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch.inputs import train_batch
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import build_model
from repro_torch.sharding import (batch_shardings, cache_shardings,
                                  param_shardings)

rank, port, data, model_ax = (int(a) for a in sys.argv[1:5])
archs = sys.argv[5].split(",")
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mesh = make_dev_mesh(data, model_ax, device="cpu")
torch.manual_seed(0)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(a, b):
    a, b = full(a).detach().float(), b.detach().float()
    assert a.shape == b.shape, (a.shape, b.shape)
    return [float((a - b).abs().max()), float(b.abs().max())]


def build(cfg, train):
    m = build_model(cfg).init(torch.Generator().manual_seed(0))
    return m.requires_grad_(train)


def place(model, train):
    specs = dict(model.named_parameters())
    shard = param_shardings(specs, mesh)
    for name, p in specs.items():
        path, _, leaf = name.rpartition(".")
        d = nn.Parameter(distribute_tensor(p.detach(), mesh,
                                           shard[name].placements),
                         requires_grad=train)
        model.get_submodule(path).register_parameter(leaf, d)
    return dict(model.named_parameters())


out = {}
for arch in archs:
    cfg = get_config(arch, reduced=True)
    batch = train_batch(cfg, 4, 32, device="cpu")
    plain = build(cfg, True)
    pp = dict(plain.named_parameters())
    loss = plain.loss(batch)
    grads = torch.autograd.grad(loss, list(pp.values()))

    sharded = build(cfg, True)
    sp = place(sharded, True)
    bs = batch_shardings(batch, mesh)
    db = {k: distribute_tensor(v, mesh, bs[k].placements)
          for k, v in batch.items()}
    with implicit_replication():
        dloss = sharded.loss(db)
        dgrads = torch.autograd.grad(dloss, list(sp.values()))
    res = {"loss": err(dloss, loss)}
    res.update({f"grad:{k}": err(g, gp) for k, g, gp in
                zip(pp, dgrads, grads)})

    if cfg.family == "ssm":
        # prefill, then one decode step on the plain prefill's cache placed
        # by the decode cache's shardings, as the dry-run places it
        ids = batch["tokens"]
        serve = build(cfg, False)
        place(serve, False)
        with torch.no_grad():
            logits, cache = plain.prefill(ids, 64)
            nxt = torch.argmax(logits, -1)[:, None].int()
            cs = cache_shardings(cache, mesh)
            dcache = {k: distribute_tensor(v.clone(), mesh, cs[k].placements)
                      if k in cs else v for k, v in cache.items()}
            pre = {k: cache[k].clone() for k in ("conv", "ssm")}
            # decode_step writes the cache in place
            step_logits, step_cache = plain.decode_step(cache, nxt)
            did = distribute_tensor(ids, mesh, batch_shardings(
                ids, mesh).placements)
            dnxt = distribute_tensor(nxt, mesh, batch_shardings(
                nxt, mesh).placements)
            with implicit_replication():
                dlogits, dpre = serve.prefill(did, 64)
                dstep, dstep_cache = serve.decode_step(dcache, dnxt)
        res["prefill_logits"] = err(dlogits, logits)
        res["prefill_conv"] = err(dpre["conv"], pre["conv"])
        res["prefill_ssm"] = err(dpre["ssm"], pre["ssm"])
        res["decode_logits"] = err(dstep, step_logits)
        res["decode_conv"] = err(dstep_cache["conv"], step_cache["conv"])
        res["decode_ssm"] = err(dstep_cache["ssm"], step_cache["ssm"])
    out[arch] = res

dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(data: int, model: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", SNIPPET, str(r), port, str(data), str(model),
         ",".join(ARCHS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module", params=[(2, 1), (1, 2)],
                ids=["mesh2x1", "mesh1x2"])
def results(request):
    return request.param, _run(*request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_on_dtensors_match_plain(results, arch):
    """The loss and every parameter's gradient of a sharded training step
    equal the plain model's within f32 rounding."""
    mesh, res = results
    got = {k: v for k, v in res[arch].items()
           if k == "loss" or k.startswith("grad:")}
    assert len(got) > 2
    bad = {k: v for k, v in got.items() if v[0] > TOL * (1 + v[1])}
    assert not bad, (mesh, arch, bad)


def test_mamba2_prefill_and_decode_on_dtensors_match_plain(results):
    """Mamba2's prefill (logits, conv tails, states) and a decode step on
    a cache placed by ``cache_shardings`` equal the plain model's."""
    mesh, res = results
    got = {k: v for k, v in res["mamba2_370m"].items()
           if k.startswith(("prefill", "decode"))}
    assert len(got) == 6
    bad = {k: v for k, v in got.items() if v[0] > TOL * (1 + v[1])}
    assert not bad, (mesh, bad)
