"""The torch port's SSM serving slice held against the JAX package on the CPU.

Reduced mamba2-370m (ssm) and zamba2-7b (hybrid), f32 parameters and
activations, are initialised by the JAX models' ``init`` and carried into
the port by ``model_from_numpy``; prefill, the primed cache, decode steps and
whole ``ServeLoop`` runs are compared.  Tolerance for logits and caches:
1e-4 absolute, for f32 sums over the same layers taken in another order by
two frameworks (the measured gap is under 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jax_mamba2
from repro.runtime import ServeLoop as JaxServeLoop
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.launch import serve
from repro_torch.models import Mamba2LM, Zamba2LM, build_model
from repro_torch.models import mamba2 as port_mamba2
from repro_torch.models.convert import model_from_numpy
from repro_torch.runtime import ServeLoop
from torch_parity import keep_reference_ids  # noqa: F401

SSM = ["mamba2-370m", "zamba2-7b"]
TOL = dict(atol=1e-4, rtol=0)
MAX_LEN = 96
# 70 = 4 * 16 + 6: not a multiple of the reduced ssm_chunk (16)
PROMPT_LEN = 70


def _configs(name, flash=True):
    return (dataclasses.replace(jax_config(name, reduced=True),
                                flash_attention=flash),
            dataclasses.replace(get_config(name, reduced=True),
                                flash_attention=flash))


@pytest.fixture(scope="module", params=SSM)
def pair(request):
    """(name, JAX params, numpy copy of them) for one reduced config."""
    jcfg, _ = _configs(request.param)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.array, params)


def _prompt(vocab, B=2, S=PROMPT_LEN, seed=1, left_pad=0):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                               dtype=np.int32)
    ids[0, :left_pad] = 0                 # left-padded, as ServeLoop pads
    return ids


# -- models and weights -------------------------------------------------------------
def test_build_model_maps_the_ssm_families():
    assert type(build_model(get_config("mamba2-370m"))) is Mamba2LM
    assert type(build_model(get_config("zamba2-7b"))) is Zamba2LM
    with pytest.raises(ValueError, match="dense"):
        Zamba2LM(get_config("qwen2-1.5b", reduced=True))


def test_init_draws_jax_scales_on_the_generator_device():
    cfg = get_config("mamba2-370m", reduced=True)
    model = Mamba2LM(cfg).init(torch.Generator().manual_seed(0))
    lp = model.layers[0]
    h, di = model.nheads, model.d_inner
    assert len(model.layers) == cfg.num_layers and "head" not in model.params
    torch.testing.assert_close(lp["A_log"],
                               torch.log(torch.linspace(1.0, 16.0, h)))
    assert lp["D"].eq(1).all() and lp["conv_b"].eq(0).all()
    torch.testing.assert_close(torch.nn.functional.softplus(lp["dt_bias"]),
                               torch.full((h,), 0.01))
    for w, scale in [(model.params["embed"]["e"], 0.02),
                     (lp["conv_w"], 0.5),
                     (lp["in_proj"]["w"], cfg.d_model ** -0.5),
                     (lp["out_proj"]["w"], (di * 2 * cfg.num_layers) ** -0.5)]:
        assert w.dtype == torch.float32 and not w.requires_grad
        assert abs(w.std().item() / scale - 1) < 0.1
    zcfg = get_config("zamba2-7b", reduced=True)
    z = Zamba2LM(zcfg).init(torch.Generator().manual_seed(0))
    assert len(z.layers) == zcfg.num_layers and "head" in z.params
    assert z.params["shared"]["attn"]["wq"]["w"].shape == (zcfg.d_model,
                                                          zcfg.num_heads * zcfg.hd)


def test_converted_weights_equal_the_jax_tree(pair):
    name, _, arrays = pair
    _, cfg = _configs(name)
    model = model_from_numpy(cfg, arrays, "cpu")
    np.testing.assert_array_equal(model.params["embed"]["e"].numpy(),
                                  arrays["embed"]["e"])
    for i, lp in enumerate(model.layers):
        for key in ("conv_w", "A_log", "dt_bias"):
            np.testing.assert_array_equal(lp[key].numpy(),
                                          arrays["layers"][key][i])
        np.testing.assert_array_equal(lp["in_proj"]["w"].numpy(),
                                      arrays["layers"]["in_proj"]["w"][i])
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(
            model.params["shared"]["attn"]["wk"]["w"].numpy(),
            arrays["shared"]["attn"]["wk"]["w"])


def test_layer_returns_a_conv_tail_that_owns_its_memory():
    """The conv tail primes the decode cache; a view of the in_proj output
    would keep that whole output alive for every layer until prefill
    stacks the cache (3 GB at mamba2-370m's full width, batch 4 x 1841)."""
    cfg = get_config("mamba2-370m", reduced=True)
    model = Mamba2LM(cfg).init(torch.Generator().manual_seed(0))
    x = torch.randn(2, 40, cfg.d_model)
    with torch.inference_mode():
        _, conv_tail, hlast = model.layer(model.layers[0], x)
    assert conv_tail.shape == (2, 3, model.conv_dim)
    assert conv_tail.untyped_storage().nbytes() == \
        conv_tail.numel() * conv_tail.element_size()
    assert hlast.dtype == torch.float32


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    b = rng.standard_normal((6,), dtype=np.float32)
    exp = jax_mamba2.causal_conv(*map(jnp.asarray, (x, w, b)))
    got = port_mamba2.causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)


# -- prefill and decode against the JAX model ---------------------------------------
@pytest.mark.parametrize("S,left_pad", [(PROMPT_LEN, 0), (64, 0),
                                        (PROMPT_LEN, 23)])
def test_prefill_logits_and_cache_match_jax(pair, S, left_pad):
    name, params, arrays = pair
    jcfg, cfg = _configs(name)
    ids = _prompt(cfg.vocab_size, S=S, left_pad=left_pad)
    jlogits, jcache = jax_build_model(jcfg).prefill(params, jnp.asarray(ids),
                                                    max_len=MAX_LEN)
    model = model_from_numpy(cfg, arrays, "cpu")
    n0 = ssd_scan.launches
    with torch.inference_mode():
        logits, cache = model.prefill(torch.from_numpy(ids).long(), MAX_LEN)
    assert ssd_scan.launches == n0             # the CPU runs the plain version
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    keys = ["conv", "ssm"] + (["k", "v"] if cfg.family == "hybrid" else [])
    empty = model.init_cache(2, MAX_LEN)
    jempty = jax_build_model(jcfg).init_cache(2, MAX_LEN)
    for key in keys:
        assert empty[key].shape == cache[key].shape == jempty[key].shape
        assert cache[key].dtype == cfg.adt
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **TOL)
    if cfg.family == "hybrid":
        np.testing.assert_array_equal(cache["kpos"].numpy(),
                                      np.asarray(jcache["kpos"]))
    assert cache["pos"] == int(jcache["pos"]) == S


@pytest.mark.parametrize("flash", [False, True])
def test_decode_steps_match_jax(pair, flash):
    """Eight decode steps on the JAX model's own tokens."""
    name, params, arrays = pair
    jcfg, cfg = _configs(name, flash)
    jm = jax_build_model(jcfg)
    ids = _prompt(cfg.vocab_size, seed=2)
    jlogits, jcache = jm.prefill(params, jnp.asarray(ids), max_len=MAX_LEN)
    model = model_from_numpy(cfg, arrays, "cpu")
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        logits, cache = model.prefill(torch.from_numpy(ids).long(), MAX_LEN)
        for _ in range(8):
            tok = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
            jlogits, jcache = decode(params, jcache, jnp.asarray(tok))
            logits, cache = model.decode_step(cache,
                                              torch.from_numpy(tok).long())
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   **TOL)
    assert cache["pos"] == int(jcache["pos"]) == PROMPT_LEN + 8


def test_prefill_then_decode_matches_forward(pair):
    """The port against itself, as tests/test_models.py holds the JAX
    models: the chunked scan's prefill plus recurrent decode steps give the
    teacher-forced logits of one forward pass (f32, 1e-4)."""
    name, _, arrays = pair
    _, cfg = _configs(name)
    model = model_from_numpy(cfg, arrays, "cpu")
    ids = torch.from_numpy(_prompt(cfg.vocab_size, B=1, S=40, seed=6)).long()
    S0 = 21                                    # a ragged prefill
    with torch.inference_mode():
        full, aux = model(ids)
        logits, cache = model.prefill(ids[:, :S0], max_len=48)
        torch.testing.assert_close(logits, full[:, S0 - 1], **TOL)
        for t in range(S0, ids.shape[1]):
            logits, cache = model.decode_step(cache, ids[:, t:t + 1])
            torch.testing.assert_close(logits, full[:, t], **TOL)
    assert aux == 0.0


def test_prefill_routes_every_layer_through_the_ssd_wrapper(pair,
                                                            monkeypatch):
    """One call of ``kernels.ssd_scan`` per Mamba2 layer and prefill, and for
    zamba2 one flash-attention call per group; decode calls neither."""
    name, _, arrays = pair
    _, cfg = _configs(name)
    calls = {"ssd": 0, "flash": 0}

    def counting(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(port_mamba2, "ssd_scan",
                        counting("ssd", port_mamba2.ssd_scan))
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "flash_attention",
                        counting("flash", flash_attention))
    model = model_from_numpy(cfg, arrays, "cpu")
    ids = torch.from_numpy(_prompt(cfg.vocab_size, S=33, seed=7)).long()
    with torch.inference_mode():
        _, cache = model.prefill(ids, max_len=48)
        model.decode_step(cache, ids[:, :1])
    groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert calls == {"ssd": cfg.num_layers, "flash": groups}


# -- serving ------------------------------------------------------------------------
def test_serve_loops_give_identical_tokens(pair):
    """Three requests of 40-90 tokens, two per batch (left-padded), through
    both ServeLoops."""
    name, params, arrays = pair
    jcfg, cfg = _configs(name)
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


def test_launch_serve_main_runs_mamba2_on_cpu(capsys):
    serve.main(["--arch", "mamba2-370m", "--requests", "3", "--max-new", "4",
                "--max-batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] mamba2-370m: 3 requests, 12 tokens")
    assert "2 batches, 6 decode steps on cpu" in out[0]
    assert len(out) == 4
