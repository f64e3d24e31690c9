"""The torch port's MoE layer and granite configs held against the JAX
package on the CPU.

``moe`` alone on the same weights and inputs, with tokens dropped
(capacity factor 1.25) and without (16), for two group sizes; the JAX
package's MoE invariants on the port; reduced granite-moe (f32 parameters
and activations) carried over by ``model_from_numpy``: prefill, decode,
``ServeLoop`` tokens, and the loss (with its ``0.01 * aux`` term) and
gradients against ``jax.grad``.  Tolerances are the dense family's: logits
1e-4 absolute, losses 1e-5 relative, each gradient 1e-4 of its largest
reference magnitude (f32 sums taken in other orders by two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_grads_match

from repro.configs import get_config as jax_config
from repro.models import ArchConfig as JaxArchConfig
from repro.models import DecoderLM as JaxDecoderLM
from repro.models import layers as JL
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention
from repro_torch.models import ArchConfig, DecoderLM, build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import model_from_numpy
from repro_torch.runtime import ServeLoop
from torch_parity import keep_reference_ids  # noqa: F401

ARCH = "granite-moe-3b-a800m"
LOGIT_TOL = dict(atol=1e-4, rtol=0)
MAX_LEN = 96


def _tiny(cls, **kw):
    """``tests/test_models.py``'s ``tiny("moe", ...)`` in either package."""
    cfg = cls(name="tiny-moe", family="moe", num_layers=30, d_model=256,
              num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512)
    return dataclasses.replace(cfg.reduced(), **kw)


def _configs(name=ARCH, **kw):
    return (dataclasses.replace(jax_config(name, reduced=True), **kw),
            dataclasses.replace(get_config(name, reduced=True), **kw))


@pytest.fixture(scope="module")
def granite():
    """JAX params of reduced granite-moe and a numpy copy of them."""
    jcfg, _ = _configs()
    params = JaxDecoderLM(jcfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.array, params)


def _tokens(vocab, B=2, S=70, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)


# -- the layer ---------------------------------------------------------------------
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("group_size", [16, 64])
def test_moe_layer_matches_jax(capacity_factor, group_size):
    """Output within 1e-4 and aux within 1e-6 relative; at 1.25 some
    assignments are dropped (the output differs from the run at 16), at 16
    none."""
    kw = dict(num_experts=8, top_k=2, d_model=64, d_ff=32)
    jcfg = _tiny(JaxArchConfig, capacity_factor=capacity_factor, **kw)
    cfg = _tiny(ArchConfig, capacity_factor=capacity_factor, **kw)
    p = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(2).standard_normal((2, 32, 64), np.float32)
    jout, jaux = jax.jit(JL.moe, static_argnums=1,
                         static_argnames="group_size")(
        p, jcfg, jnp.asarray(x), group_size=group_size)
    tp = L.Tree(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))
    out, aux = L.moe(tp, cfg, torch.from_numpy(x), group_size=group_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    undropped, _ = L.moe(tp, dataclasses.replace(cfg, capacity_factor=16.0),
                         torch.from_numpy(x), group_size=group_size)
    assert torch.equal(out, undropped) == (capacity_factor == 16.0)


def test_moe_routing_weights_normalized():
    """``tests/test_models.py``'s invariant on the port: shape kept, aux at
    least 1 (its lower bound, balanced routing), no NaN."""
    cfg = _tiny(ArchConfig, num_experts=8, top_k=2, d_model=64, d_ff=32)
    p = L.Tree(L.init_moe(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(1))
    out, aux = L.moe(p, cfg, x, group_size=16)
    assert out.shape == x.shape
    assert float(aux) >= 1.0 - 1e-3
    assert not torch.isnan(out).any()


def test_moe_capacity_drops_tokens_gracefully():
    cfg = _tiny(ArchConfig, num_experts=4, top_k=2, d_model=64, d_ff=32,
                capacity_factor=0.25)
    p = L.Tree(L.init_moe(cfg, torch.Generator().manual_seed(0)))
    x = torch.randn(1, 32, 64, generator=torch.Generator().manual_seed(1))
    out, _ = L.moe(p, cfg, x, group_size=32)
    assert not torch.isnan(out).any()


def test_moe_refuses_tokens_the_group_does_not_divide():
    """Above one group, ``B * S`` must be a multiple of the group size: the
    JAX layer asserts it, the port raises; neither pads."""
    kw = dict(num_experts=4, top_k=2, d_model=64, d_ff=32)
    jcfg, cfg = _tiny(JaxArchConfig, **kw), _tiny(ArchConfig, **kw)
    p = JL.init_moe(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(AssertionError, match="not divisible"):
        JL.moe(p, jcfg, jnp.zeros((2, 300, 64)), group_size=512)
    tp = L.Tree(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))
    with pytest.raises(ValueError, match="not divisible"):
        L.moe(tp, cfg, torch.zeros(2, 300, 64), group_size=512)
    out, _ = L.moe(tp, cfg, torch.zeros(4, 256, 64), group_size=512)
    assert out.shape == (4, 256, 64)


def test_init_draws_jax_scales_and_layout():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    model = DecoderLM(cfg).init(torch.Generator().manual_seed(0))
    m = model.layers[0]["moe"]
    E, d, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert "mlp" not in model.layers[0] and m["router"]["w"].shape == (d, E)
    assert m["wi"].shape == m["wg"].shape == (E, d, F)
    assert m["wo"].shape == (E, F, d) and m["router"]["w"].dtype == torch.float32
    for w, scale in [(m["router"]["w"], d ** -0.5), (m["wg"], d ** -0.5),
                     (m["wo"], (F * 2 * cfg.num_layers) ** -0.5)]:
        assert abs(w.std().item() / scale - 1) < 0.1


# -- reduced granite-moe against the JAX model ---------------------------------------
@pytest.mark.parametrize("flash", [False, True])
def test_prefill_logits_and_cache_match_jax(granite, flash):
    params, arrays = granite
    jcfg, cfg = _configs(flash_attention=flash)
    ids = _tokens(cfg.vocab_size)
    jlogits, jcache = JaxDecoderLM(jcfg).prefill(params, jnp.asarray(ids),
                                                 max_len=MAX_LEN)
    model = model_from_numpy(cfg, arrays, "cpu")
    with torch.inference_mode():
        logits, cache = model.prefill(torch.from_numpy(ids).long(), MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   atol=2e-5, rtol=0)
    assert cache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_decode_steps_match_jax(granite, capacity_factor):
    """Eight decode steps on the JAX model's tokens; a decode step routes
    its B = 2 tokens as one group (capacity 2 at 1.25: assignments drop, in
    both packages alike)."""
    params, arrays = granite
    jcfg, cfg = _configs(capacity_factor=capacity_factor)
    jm = JaxDecoderLM(jcfg)
    ids = _tokens(cfg.vocab_size, seed=2)
    jlogits, jcache = jm.prefill(params, jnp.asarray(ids), max_len=MAX_LEN)
    model = model_from_numpy(cfg, arrays, "cpu")
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        _, cache = model.prefill(torch.from_numpy(ids).long(), MAX_LEN)
        for _ in range(8):
            tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
            jlogits, jcache = decode(params, jcache, jnp.asarray(tok))
            logits, cache = model.decode_step(cache,
                                              torch.from_numpy(tok).long())
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **LOGIT_TOL)


def test_prefill_then_decode_equals_prefill_without_drops(granite):
    """``tests/test_models.py``'s decode check, held only where nothing is
    dropped (capacity factor 16): prefill of S - 1 tokens plus one decode
    step gives the whole prefill's last logits."""
    _, arrays = granite
    _, cfg = _configs(capacity_factor=16.0)
    model = model_from_numpy(cfg, arrays, "cpu")
    ids = torch.from_numpy(_tokens(cfg.vocab_size, B=1, S=16, seed=3)).long()
    with torch.inference_mode():
        full, _ = model.prefill(ids, MAX_LEN)
        _, cache = model.prefill(ids[:, :-1], MAX_LEN)
        step, _ = model.decode_step(cache, ids[:, -1:])
    torch.testing.assert_close(step, full, atol=2e-3, rtol=2e-3)


def test_serve_loops_give_identical_tokens(granite):
    """Three requests of 40-90 tokens, two per batch (left-padded), through
    both ServeLoops with B3's plain version in prefill."""
    params, arrays = granite
    jcfg, cfg = _configs(flash_attention=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 90, 65)]
    jsl = JaxServeLoop(jcfg, params, max_batch=2, max_len=128)
    sl = ServeLoop(cfg, model_from_numpy(cfg, arrays, "cpu"), max_batch=2,
                   max_len=128, device="cpu")
    outs = []
    for loop in (jsl, sl):
        reqs = [loop.submit(p, max_new=6) for p in prompts]
        loop.run_until_idle()
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert sl.stats == jsl.stats


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_gradients_match_jax(granite, flash):
    """The loss with its aux term within 1e-5 relative, every gradient
    within 1e-4 of its largest reference magnitude; the aux term is live
    (the router's gradient is not zero)."""
    params, arrays = granite
    jcfg, cfg = _configs(flash_attention=flash)
    toks = _tokens(cfg.vocab_size, B=2, S=48, seed=5)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    jloss, jgrads = jax.jit(jax.value_and_grad(JaxDecoderLM(jcfg).loss))(
        params, jb)
    model = model_from_numpy(cfg, arrays, "cpu").requires_grad_(True)
    t = torch.from_numpy(toks)
    n0 = flash_attention.launches
    loss = model.loss({"tokens": t, "labels": t})
    loss.backward()
    assert flash_attention.launches == n0       # the CPU runs no kernel
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _, aux = model.forward(t)
    assert aux.item() > 0
    assert_grads_match(model, jgrads, "moe")
    assert model.layers[0]["moe"]["router"]["w"].grad.abs().max() > 0


def test_build_model_and_launcher_serve_granite(capsys):
    from repro_torch.launch import serve
    assert type(build_model(get_config(ARCH))) is DecoderLM
    serve.main(["--arch", "granite-moe-1b-a400m", "--requests", "3",
                "--max-new", "4", "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] granite-moe-1b-a400m: 3 requests, "
                             "12 tokens")
