"""Training the ssm and hybrid families on the torch port, held against the
JAX package on the CPU.

Kernel B4 under autograd (``ssd_scan``'s Function: the plain forward on the
CPU, the backward autograd of the plain version recomputed from the
inputs) against ``jax.grad`` through ``repro.models.mamba2.ssd_chunked``,
at ``tests/test_models.py``'s 2e-4; reduced mamba2-370m and zamba2-7b
losses and gradients against ``jax.grad`` of the JAX models' losses from
the same weights (the dense family's tolerances: loss 1e-5 relative, each
gradient 1e-4 of its largest reference magnitude).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_grads_match, rel

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.models.mamba2 import ssd_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.convert import model_from_numpy
from torch_parity import keep_reference_ids  # noqa: F401


def _inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    a = -np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, a, B, C


# (s, chunk): tests/test_models.py's, and a ragged s (50 = 3 * 16 + 2)
@pytest.mark.parametrize("s,chunk", [(8, 4), (32, 8), (64, 64), (48, 16),
                                     (50, 16)])
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_scan_gradients_match_jax(s, chunk, use_state):
    """dx, da, dB, dC within 2e-4 of the largest of ``jax.grad``'s through
    ``ssd_chunked``, for a loss on y alone and on y and the final state."""
    b, h, p, n = 2, 3, 4, 5
    arrs = _inputs(b, s, h, p, n, seed=s + chunk)
    rng = np.random.default_rng(7)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dst = rng.standard_normal((b, h, p, n), dtype=np.float32)

    def f(x, a, B, C):
        y, st = ssd_chunked(x, a, B, C, chunk)
        return jnp.sum(y * dy) + (jnp.sum(st * dst) if use_state else 0.0)

    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, st = ssd_scan(*ts, chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if use_state:
        loss = loss + (st * torch.from_numpy(dst)).sum()
    loss.backward()
    for name, exp, t in zip(("x", "a", "B", "C"), jg, ts):
        assert t.grad.shape == t.shape
        assert rel(t.grad.numpy(), exp) <= 2e-4, name


def test_ssd_scan_function_forward_is_the_plain_version():
    """Under autograd the outputs are the plain version's bit for bit; only
    the inputs that require grad get one, and no kernel runs on the CPU."""
    arrs = [torch.from_numpy(a) for a in _inputs(1, 40, 2, 8, 4, seed=3)]
    y0, st0 = ssd_scan_plain(*arrs, 16)
    x = arrs[0].clone().requires_grad_()
    n0 = ssd_scan.launches
    y, st = ssd_scan(x, *arrs[1:], 16)
    assert y.requires_grad and torch.equal(y.detach(), y0)
    assert torch.equal(st.detach(), st0)
    y.sum().backward()
    assert x.grad is not None and arrs[1].grad is None
    assert ssd_scan.launches == n0


@pytest.fixture(scope="module", params=["mamba2-370m", "zamba2-7b"])
def ssm(request):
    jcfg = dataclasses.replace(jax_config(request.param, reduced=True),
                               flash_attention=True)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return request.param, jcfg, params, jax.tree.map(np.array, params)


def test_loss_and_gradients_match_jax(ssm):
    """Reduced mamba2-370m and zamba2-7b (f32): a 70-token batch (not a
    multiple of the reduced ssm_chunk of 16); B4's Function in every Mamba2
    layer, B3's in zamba2's shared block (plain versions on the CPU)."""
    name, jcfg, params, arrays = ssm
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              flash_attention=True)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 70),
                                             dtype=np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        params, jb)
    model = model_from_numpy(cfg, arrays, "cpu").requires_grad_(True)
    t = torch.from_numpy(toks)
    n0, f0 = ssd_scan.launches, flash_attention.launches
    loss = model.loss({"tokens": t, "labels": t})
    loss.backward()
    assert (ssd_scan.launches, flash_attention.launches) == (n0, f0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_grads_match(model, jgrads, cfg.family)
