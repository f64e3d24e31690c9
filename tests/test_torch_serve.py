"""The torch port's serving slice held against the JAX package on the CPU.

The four dense configs at their reduced size (f32 parameters and
activations) are initialised by ``repro.models.DecoderLM.init`` and carried
into the port by ``model_from_numpy``; prefill, the primed cache, decode
steps and whole ``ServeLoop`` runs are compared.  Tolerance for logits:
1e-4 absolute, for f32 sums over the same two layers taken in another order
by two frameworks (the measured gap is under 5e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import DecoderLM as JaxDecoderLM
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.configs import ALIASES, ARCHITECTURES, LONG_CONTEXT_OK, SHAPES
from repro_torch.configs import cells
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.models.convert import model_from_numpy
from repro_torch.runtime import ServeLoop
from torch_parity import keep_reference_ids  # noqa: F401

DENSE = ["qwen2-1.5b", "h2o-danube-1.8b", "starcoder2-3b", "minitron-4b"]
LOGIT_TOL = dict(atol=1e-4, rtol=0)
MAX_LEN = 96
# 70 > 64, h2o-danube's reduced window: its ring buffer wraps in prefill
PROMPT_LEN = 70


def _configs(name, flash=False):
    return (dataclasses.replace(jax_config(name, reduced=True),
                                flash_attention=flash),
            dataclasses.replace(get_config(name, reduced=True),
                                flash_attention=flash))


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(name, JAX params, numpy copy of them) for one reduced dense config."""
    jcfg, _ = _configs(request.param)
    params = JaxDecoderLM(jcfg).init(jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.array, params)


def _prompt(vocab, B=2, S=PROMPT_LEN, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)


# -- configs ----------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("module", ARCHITECTURES)
def test_config_matches_jax(module, reduced):
    jcfg = jax_config(module, reduced=reduced)
    cfg = get_config(module, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (str(cfg.pdt), str(cfg.adt)) == (f"torch.{jcfg.pdt}",
                                             f"torch.{jcfg.adt}")
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        jcfg.param_count(active_only=True)


def test_registry_matches_jax():
    from repro import configs as jc
    assert ARCHITECTURES == jc.ARCHITECTURES and ALIASES == jc.ALIASES
    assert SHAPES == jc.SHAPES and LONG_CONTEXT_OK == jc.LONG_CONTEXT_OK
    for arch in ARCHITECTURES:
        assert cells(arch) == jc.cells(arch)


# -- weights --------------------------------------------------------------------
def test_init_draws_jax_scales_on_the_generator_device():
    cfg = get_config("starcoder2-3b", reduced=True)   # untied head, gelu
    model = DecoderLM(cfg).init(torch.Generator().manual_seed(0))
    p, lp = model.params, model.layers[0]
    assert len(model.layers) == cfg.num_layers and "head" in p
    d, F = cfg.d_model, cfg.d_ff
    H, hd = cfg.num_heads, cfg.hd
    for w, scale in [(p["embed"]["e"], 0.02), (p["head"]["w"], d ** -0.5),
                     (lp["attn"]["wq"]["w"], d ** -0.5),
                     (lp["attn"]["wo"]["w"], (H * hd * 2 * cfg.num_layers) ** -0.5),
                     (lp["mlp"]["wo"]["w"], (F * 2 * cfg.num_layers) ** -0.5)]:
        assert w.dtype == torch.float32 and not w.requires_grad
        assert abs(w.std().item() / scale - 1) < 0.1
    assert not lp["attn"]["wq"]["b"].any() and lp["ln1"]["g"].eq(1).all()
    assert "wg" not in lp["mlp"]


def test_converted_weights_equal_the_jax_tree(pair):
    name, _, arrays = pair
    _, cfg = _configs(name)
    model = model_from_numpy(cfg, arrays, "cpu")
    np.testing.assert_array_equal(model.params["embed"]["e"].numpy(),
                                  arrays["embed"]["e"])
    for i, lp in enumerate(model.layers):
        np.testing.assert_array_equal(lp["attn"]["wk"]["w"].numpy(),
                                      arrays["layers"]["attn"]["wk"]["w"][i])
        np.testing.assert_array_equal(lp["mlp"]["wo"]["w"].numpy(),
                                      arrays["layers"]["mlp"]["wo"]["w"][i])


# -- prefill and decode against the JAX model ---------------------------------------
def test_prefill_logits_and_cache_match_jax(pair):
    name, params, arrays = pair
    jcfg, cfg = _configs(name)
    ids = _prompt(cfg.vocab_size)
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
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    assert cache["pos"] == int(jcache["pos"]) == PROMPT_LEN
    if cfg.sliding_window:
        assert cache["k"].shape[2] == cfg.sliding_window < PROMPT_LEN


@pytest.mark.parametrize("flash", [False, True])
def test_decode_steps_match_jax(pair, flash):
    """Eight decode steps on the JAX model's own tokens; for h2o-danube the
    ring buffer keeps wrapping."""
    name, params, arrays = pair
    jcfg, cfg = _configs(name, flash)
    jm = JaxDecoderLM(jcfg)
    ids = _prompt(cfg.vocab_size, seed=2)
    jlogits, jcache = jm.prefill(params, jnp.asarray(ids), max_len=MAX_LEN)
    model = model_from_numpy(cfg, arrays, "cpu")
    with torch.inference_mode():
        logits, cache = model.prefill(torch.from_numpy(ids).long(), MAX_LEN)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        decode = jax.jit(jm.decode_step)
        for _ in range(8):
            tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
            jlogits, jcache = decode(params, jcache, jnp.asarray(tok))
            logits, cache = model.decode_step(cache,
                                              torch.from_numpy(tok).long())
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **LOGIT_TOL)
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    assert cache["pos"] == int(jcache["pos"])


def test_serve_loops_give_identical_tokens(pair):
    """Three requests of 40-90 tokens, two per batch (left-padded), through
    both ServeLoops."""
    name, params, arrays = pair
    jcfg, cfg = _configs(name, flash=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 90, 65)]
    jsl = JaxServeLoop(jcfg, params, max_batch=2, max_len=128)
    sl = ServeLoop(cfg, model_from_numpy(cfg, arrays, "cpu"), max_batch=2,
                   max_len=128, device="cpu")
    outs = []
    for loop in (jsl, sl):
        reqs = [loop.submit(p, max_new=6) for p in prompts]
        loop.run_until_idle()
        assert all(r.done.is_set() for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert sl.stats == jsl.stats == {"batches": 2, "decode_steps": 10,
                                     "requests": 3}


# -- routing, devices, launcher -----------------------------------------------------
def test_sdpa_routes_long_causal_prefill_to_flash(monkeypatch):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 2, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 12, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 12, 2, 16), np.float32))
    mask = L.causal_mask(12, 12, window=5)
    einsum = L._sdpa(q, k, v, mask, causal=True, window=5)
    flash = flash_attention(q, k, v, causal=True, window=5)
    torch.testing.assert_close(einsum, flash, atol=2e-5, rtol=2e-5)
    assert not torch.equal(L._sdpa(q, k, v, mask, causal=True, window=5),
                           flash)
    monkeypatch.setattr(L, "FLASH_THRESHOLD", 12 * 12 - 1)
    assert torch.equal(L._sdpa(q, k, v, mask, causal=True, window=5), flash)
    assert torch.equal(L._sdpa(q, k, v, mask, use_kernel=True, causal=True,
                               window=5), flash)


def test_serve_loop_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(get_config("qwen2-1.5b", reduced=True))


def test_take_batch_takes_one_request_at_max_batch_zero():
    """Both loops take one request before they look at ``max_batch``: at
    ``max_batch=0`` a batch holds one request and the rest stay queued."""
    jcfg, cfg = _configs("qwen2-1.5b")
    jsl = JaxServeLoop(jcfg, max_batch=0, max_len=MAX_LEN)
    sl = ServeLoop(cfg, max_batch=0, max_len=MAX_LEN, device="cpu")
    prompts = [_prompt(cfg.vocab_size, B=1, S=8, seed=i)[0] for i in range(3)]
    for loop in (jsl, sl):
        for p in prompts:
            loop.submit(p, max_new=1)
    jbatch, batch = jsl._take_batch(), sl._take_batch()
    assert [r.rid for r in batch] == [r.rid for r in jbatch] == [1]
    assert sl.queue.qsize() == jsl.queue.qsize() == 2


def test_launch_serve_main_runs_on_cpu(capsys):
    serve.main(["--arch", "h2o-danube-1.8b", "--requests", "3",
                "--max-new", "4", "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] h2o-danube-1.8b: 3 requests, 12 tokens")
    assert "2 batches, 6 decode steps on cpu" in out[0]
    assert len(out) == 4
