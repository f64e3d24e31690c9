"""The port's sharding rules against the JAX package's, on the CPU.

For every architecture at full width, on the (1,1), (4,2), (16,16) and
(2,16,16) meshes, each parameter's spec, each ZeRO-1 moment's and each
decode cache tensor's (at ``decode_32k``) equals the reference's.  The JAX
tree stacks a layer's arrays under a leading ``[L, ...]`` axis and the port
keeps one tree per layer, so a stacked leaf's reference spec is compared
without its leading entry.  The reference runs in a subprocess with 512
host devices and ``jax.eval_shape`` (nothing compiles), as
``tests/test_dryrun.py`` runs its dry-run, and prints the specs as JSON; the
port's specs come from a ``DeviceMesh`` on a fake process group
(``launch/mesh.make_mesh``; no devices) and fake tensors.

Also: the divisibility check of ``tests/test_dryrun.py`` on the port for
every arch on all four meshes, the conversion of specs to DTensor
placements, and ``CheckpointManager.restore_or_init(shardings=)`` on a
one-process gloo (1,1) ``DeviceMesh``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ARCHITECTURES, SHAPES, get_config
from repro_torch.launch.inputs import cache_specs, param_specs
from repro_torch.optim.adamw import zero1_shardings
from repro_torch.sharding import cache_shardings, named, param_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.partition import axis_size
from repro_torch.sharding.rules import _path_str

ROOT = Path(__file__).resolve().parents[1]

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}

REFERENCE = r"""
import os, json, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHITECTURES, SHAPES, get_config
from repro.launch.inputs import cache_specs, param_specs
from repro.optim.adamw import zero1_shardings
from repro.sharding import cache_shardings, param_shardings
from repro.sharding.rules import _path_str

meshes = json.loads(sys.argv[1])
devs = np.array(jax.devices())

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def by_path(pspecs, shards, stacked):
    out = {}
    def one(path, leaf, ns):
        p = _path_str(path)
        spec = enc(tuple(ns.spec))
        out[p] = {"spec": spec, "stacked": stacked(p)}
    jax.tree_util.tree_map_with_path(one, pspecs, shards)
    return out

def stacked(p):
    return bool(re.search(r"(^|/)(layers|enc|dec)/", p))

res = {}
for name, (shape, axes) in meshes.items():
    n = int(np.prod(shape))
    mesh = Mesh(devs[:n].reshape(shape), tuple(axes))
    res[name] = {}
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        _, pspecs = param_specs(cfg)
        z = zero1_shardings(pspecs, mesh)
        d = SHAPES["decode_32k"]
        cspecs = cache_specs(cfg, d["global_batch"], d["seq_len"])
        cs = cache_shardings(cspecs, mesh)
        res[name][arch] = {
            "params": by_path(pspecs, param_shardings(pspecs, mesh), stacked),
            "zero1": by_path(pspecs, z["m"], stacked),
            "step": enc(tuple(z["step"].spec)),
            "cache": {k: enc(tuple(v.spec)) for k, v in cs.items()},
        }
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(MESHES)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _enc(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, device="cpu")


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = param_specs(get_config(arch), device="cpu")[1]
    return _PARAMS[arch]


def _check(got: dict, exp: dict, what: str):
    """Each port leaf's spec against the reference's entry of its path."""
    seen = set()
    for name, ns in got.items():
        path = _path_str(name)
        ref = exp[path]
        want = ref["spec"][1:] if ref["stacked"] else ref["spec"]
        assert _enc(ns.spec) == want, (what, name, ns.spec, ref)
        seen.add(path)
    assert seen == set(exp), (what, set(exp) ^ seen)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_specs_match_reference(reference, arch, mesh):
    got = param_shardings(_params(arch), _mesh(mesh))
    _check(got, reference[mesh][arch]["params"], "params")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_zero1_specs_match_reference(reference, arch, mesh):
    z = zero1_shardings(_params(arch), _mesh(mesh))
    assert z["m"] == z["v"]
    _check(z["m"], reference[mesh][arch]["zero1"], "zero1")
    assert _enc(z["step"].spec) == reference[mesh][arch]["step"]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_cache_specs_match_reference(reference, arch, mesh):
    d = SHAPES["decode_32k"]
    cache = cache_specs(get_config(arch), d["global_batch"], d["seq_len"],
                        device="cpu")
    got = cache_shardings(cache, _mesh(mesh))
    exp = reference[mesh][arch]["cache"]
    # the port's pos is a Python int: no placement; the reference's is P()
    assert not isinstance(cache["pos"], torch.Tensor) and "pos" not in got
    assert exp.pop("pos") == []
    assert {k: _enc(v.spec) for k, v in got.items()} == exp


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharding_rules_divide_all_archs(mesh):
    """``tests/test_dryrun.py``'s divisibility check on the port: every
    param and ZeRO-1 spec evenly divides its tensor."""
    m = _mesh(mesh)
    for arch in ARCHITECTURES:
        params = _params(arch)
        z = zero1_shardings(params, m)["m"]
        for shards in (param_shardings(params, m), z):
            for name, ns in shards.items():
                for dim, s in zip(params[name].shape, ns.spec):
                    if s is None:
                        continue
                    assert dim % axis_size(m, s) == 0, (arch, name, ns.spec)


@pytest.mark.parametrize("spec,want", [
    ((), [Replicate(), Replicate(), Replicate()]),
    ((None, "model"), [Replicate(), Replicate(), Shard(1)]),
    (("model", None), [Replicate(), Replicate(), Shard(0)]),
    ((("pod", "data"), None, "model"), [Shard(0), Shard(0), Shard(2)]),
    (("data", "model"), [Replicate(), Shard(0), Shard(1)]),
])
def test_named_placements(spec, want):
    """A spec's placements, one per mesh dim; ``("pod", "data")`` shards its
    tensor dim over both mesh dims in mesh order (JAX's major-to-minor)."""
    assert named(make_mesh((2, 16, 16), ("pod", "data", "model"),
                           device="cpu"), spec) == want


def test_named_rejects_bad_specs():
    m = make_mesh((4, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError):
        named(m, ("model", "model"))
    with pytest.raises(ValueError):
        named(m, ("pod", None))


def test_pod_data_shard_matches_jax_order():
    """The local block of a tensor sharded ``("pod", "data")`` on a fake
    (2, 4) mesh is JAX's: rank r holds rows r*n/8 .. (r+1)*n/8 of the global
    tensor, with the pod index major."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    with FakeTensorMode():
        t = torch.empty(64, 3)
        d = distribute_tensor(t, mesh, named(mesh, (("pod", "data"), None)))
        assert tuple(d.to_local().shape) == (8, 3)
    # every rank's block, as DTensor nests shards: mesh dims in order
    pl = named(mesh, (("pod", "data"), None))
    for r, coord in enumerate([(p, q) for p in range(2) for q in range(4)]):
        size, offset = 64, 0
        for placement, n, c in zip(pl, mesh.shape, coord):
            size, off = Shard.local_shard_size_and_offset(size, n, c)
            offset += off
        assert (size, offset) == (8, 8 * r)


@pytest.fixture
def gloo_mesh(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_restore_or_init_with_shardings(gloo_mesh, tmp_path):
    """A checkpoint the JAX package wrote restores onto a (1,1) gloo
    ``DeviceMesh``: each tensor a DTensor with its placements and the
    reference's values; a fresh init is placed the same way."""
    import jax
    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sharding.partition import NamedSharding

    rng = np.random.default_rng(0)
    ref = {"params": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                      "b": rng.normal(size=(6,)).astype(np.float32)},
           "step": np.int32(3)}
    JaxManager(tmp_path / "ck", async_save=False).save(
        7, jax.tree.map(jax.numpy.asarray, ref))

    def init():
        return {"params": {"w": torch.zeros(4, 6), "b": torch.zeros(6)},
                "step": 0}

    sh = {"params": {"w": NamedSharding(gloo_mesh, (None, "model")),
                     "b": NamedSharding(gloo_mesh, ("model",))},
          "step": None}
    mgr = CheckpointManager(tmp_path / "ck")
    step, tree = mgr.restore_or_init(init, shardings=sh)
    assert step == 7 and tree["step"] == 3
    for k in ("w", "b"):
        t = tree["params"][k]
        assert isinstance(t, DTensor)
        assert list(t.placements) == sh["params"][k].placements
        np.testing.assert_array_equal(t.full_tensor().numpy(),
                                      ref["params"][k])

    step, fresh = CheckpointManager(tmp_path / "empty").restore_or_init(
        init, shardings=sh)
    assert step == 0 and isinstance(fresh["params"]["w"], DTensor)
    assert not fresh["params"]["w"].full_tensor().any()


def test_restore_or_init_without_shardings_unchanged(tmp_path):
    """Without ``shardings`` the restore is ``restore_checkpoint``'s, bit for
    bit, and a fresh init is ``init_fn()``'s tree itself."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(5, 3, generator=g),
            "h": torch.randn(7, generator=g).to(torch.bfloat16), "n": 2}
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(4, tree)

    def init():
        return {"w": torch.zeros(5, 3), "h": torch.zeros(7, dtype=torch.bfloat16),
                "n": 0}

    step, got = mgr.restore_or_init(init)
    _, exp = restore_checkpoint(tmp_path, init())
    assert step == 4 and got["n"] == exp["n"] == 2
    for k in ("w", "h"):
        assert not isinstance(got[k], DTensor)
        assert got[k].dtype == exp[k].dtype
        assert torch.equal(got[k], exp[k]) and torch.equal(got[k], tree[k])
    fresh = init()
    step, same = CheckpointManager(tmp_path / "none").restore_or_init(
        lambda: fresh)
    assert step == 0 and same is fresh
