"""The rest of the model zoo on the torch port, held against the JAX package
on the CPU: Whisper (audio) and InternVL (vlm), the prefill, decode and
train steps of ``launch/steps.py`` and a ``TrainLoop`` for every family,
and ``tests/test_archs.py``'s smoke runs of every architecture on the port.

Weights are the JAX models' ``init``, carried over by ``model_from_numpy``;
inputs are drawn with numpy.  Tolerances are the dense family's: logits
1e-4 absolute, losses 1e-5 relative (``TrainLoop`` losses over two steps
1e-4, as ``tests/test_torch_train.py``'s), each gradient 1e-4 of its largest
reference magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_grads_match

from repro.configs import get_config as jax_config
from repro.data import SyntheticLMData as JaxData
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.data.pipeline import D_VIS
from repro_torch.kernels import flash_attention
from repro_torch.launch import steps
from repro_torch.launch.inputs import train_batch
from repro_torch.models import InternVLModel, WhisperModel, build_model
from repro_torch.models.convert import model_from_numpy
from repro_torch.models.whisper import MAX_TGT, sinusoid
from repro_torch.runtime import ServeLoop, TrainLoop
from torch_parity import keep_reference_ids  # noqa: F401

LOGIT_TOL = dict(atol=1e-4, rtol=0)
B, S = 2, 32


def _configs(name, **kw):
    return (dataclasses.replace(jax_config(name, reduced=True), **kw),
            dataclasses.replace(get_config(name, reduced=True), **kw))


@pytest.fixture(scope="module")
def jax_models():
    """(JAX params, numpy copy) of each reduced config, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            params = jax_build_model(_configs(name)[0]).init(
                jax.random.PRNGKey(0))
            cache[name] = (params, jax.tree.map(np.array, params))
        return cache[name]

    return get


def _numpy_batch(cfg, seed=4, seq=S):
    """Tokens and, for audio and vlm, frames or image features, in f32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vis"] = rng.standard_normal(
            (B, cfg.vis_tokens, D_VIS)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- Whisper --------------------------------------------------------------------------
def test_sinusoid_is_sin_then_cos():
    from repro.models.whisper import MAX_TGT as JAX_MAX_TGT
    from repro.models.whisper import sinusoid as jax_sinusoid
    assert MAX_TGT == JAX_MAX_TGT == 32768
    np.testing.assert_allclose(sinusoid(50, 16).numpy(),
                               np.asarray(jax_sinusoid(50, 16)), atol=1e-6)
    # d = 4: angles pos / [1, 100], sines first, then cosines
    torch.testing.assert_close(sinusoid(2, 4)[1], torch.tensor(
        [np.sin(1.0), np.sin(0.01), np.cos(1.0), np.cos(0.01)],
        dtype=torch.float32))


def test_whisper_encode_and_decode_train_match_jax(jax_models):
    params, arrays = jax_models("whisper-tiny")
    jcfg, cfg = _configs("whisper-tiny")
    jm, model = jax_build_model(jcfg), model_from_numpy(cfg, arrays, "cpu")
    assert isinstance(model, WhisperModel)
    assert model.params["pos_dec"].shape == (MAX_TGT, cfg.d_model)
    batch = _numpy_batch(cfg)
    jenc = jm.encode(params, jnp.asarray(batch["frames"]))
    jlogits = jm.decode_train(params, jenc, jnp.asarray(batch["tokens"]))
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(batch["frames"]))
        logits = model.decode_train(enc, torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)


def test_whisper_decode_steps_match_jax_and_decode_train(jax_models):
    """Eight decode steps from an empty cache on the same tokens: each step's
    logits within 1e-4 of the JAX step's and of the teacher-forced
    decoder's at that position."""
    params, arrays = jax_models("whisper-tiny")
    jcfg, cfg = _configs("whisper-tiny")
    jm, model = jax_build_model(jcfg), model_from_numpy(cfg, arrays, "cpu")
    batch = _numpy_batch(cfg, seed=6)
    ids = batch["tokens"][:, :8]
    jenc = jm.encode(params, jnp.asarray(batch["frames"]))
    jcache = jm.init_cache(B, 16)
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(batch["frames"]))
        teacher = model.decode_train(enc, torch.from_numpy(ids))
        cache = model.init_cache(B, 16)
        for t in range(ids.shape[1]):
            tok = ids[:, t:t + 1]
            jlogits, jcache = decode(params, jcache, jnp.asarray(tok), jenc)
            logits, cache = model.decode_step(cache, torch.from_numpy(tok),
                                              enc)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **LOGIT_TOL)
            torch.testing.assert_close(logits, teacher[:, t], **LOGIT_TOL)
    assert cache["pos"] == int(jcache["pos"]) == ids.shape[1]
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **LOGIT_TOL)


# -- InternVL ---------------------------------------------------------------------------
@pytest.mark.parametrize("flash", [False, True])
def test_internvl_forward_prefill_and_decode_match_jax(jax_models, flash):
    """Text logits of the forward, the prefill's last logits and cache
    (slots 0..take), and six decode steps; B3's plain version on the CPU
    when ``flash`` is on."""
    params, arrays = jax_models("internvl2-26b")
    jcfg, cfg = _configs("internvl2-26b", flash_attention=flash)
    jm, model = jax_build_model(jcfg), model_from_numpy(cfg, arrays, "cpu")
    assert isinstance(model, InternVLModel)
    batch = _numpy_batch(cfg)
    jlogits, _ = jm.forward(params, _jax(batch))
    Tv = cfg.vis_tokens
    jlast, jcache = jm.prefill(params, jnp.asarray(batch["vis"]),
                               jnp.asarray(batch["tokens"]), 64)
    decode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        logits, aux = model.forward(_torch(batch))
        assert logits.shape == (B, S, cfg.vocab_size) and aux == 0.0
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        last, cache = model.prefill(torch.from_numpy(batch["vis"]),
                                    torch.from_numpy(batch["tokens"]), 64)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(cache["kpos"].numpy(),
                                      np.asarray(jcache["kpos"]))
        assert cache["pos"] == int(jcache["pos"]) == Tv + S
        for _ in range(6):
            tok = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
            jlast, jcache = decode(params, jcache, jnp.asarray(tok))
            last, cache = model.decode_step(cache, torch.from_numpy(tok))
            np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                       **LOGIT_TOL)


def test_internvl_prefill_longer_than_cache_fills_slots_from_zero(jax_models):
    """A prompt past ``max_len`` keeps its last ``max_len`` positions in
    slots 0..max_len, as the JAX model writes them."""
    params, arrays = jax_models("internvl2-26b")
    jcfg, cfg = _configs("internvl2-26b")
    batch = _numpy_batch(cfg)
    _, jcache = jax_build_model(jcfg).prefill(
        params, jnp.asarray(batch["vis"]), jnp.asarray(batch["tokens"]), 40)
    with torch.inference_mode():
        _, cache = model_from_numpy(cfg, arrays, "cpu").prefill(
            torch.from_numpy(batch["vis"]), torch.from_numpy(batch["tokens"]),
            40)
    np.testing.assert_array_equal(cache["kpos"].numpy(),
                                  np.asarray(jcache["kpos"]))
    assert cache["kpos"][0] == cfg.vis_tokens + S - 40
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b"])
def test_loss_and_gradients_match_jax(jax_models, name):
    params, arrays = jax_models(name)
    jcfg, cfg = _configs(name, flash_attention=True)
    batch = _numpy_batch(cfg, seed=7)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        params, _jax(batch))
    model = model_from_numpy(cfg, arrays, "cpu").requires_grad_(True)
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_grads_match(model, jgrads, cfg.family)


def test_serve_loop_refuses_audio_and_vlm():
    for name in ("whisper-tiny", "internvl2-26b"):
        with pytest.raises(ValueError, match="launch.steps"):
            ServeLoop(get_config(name, reduced=True), device="cpu")


# -- the steps and TrainLoop, one config of each family --------------------------------
FAMILIES = ["qwen2-1.5b", "granite-moe-1b-a400m", "mamba2-370m", "zamba2-7b",
            "whisper-tiny", "internvl2-26b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_steps_match_jax(jax_models, name):
    """The prefill step and one decode step of both packages'
    ``launch/steps.py`` from the same weights and batch.  The audio prefill
    step gives logits alone, so its decode step starts from an empty
    cache."""
    params, arrays = jax_models(name)
    jcfg, cfg = _configs(name, flash_attention=True)
    jm = jax_build_model(jcfg)
    model = model_from_numpy(cfg, arrays, "cpu")
    batch = _numpy_batch(cfg, seed=8)
    jpre = jax.jit(jax_steps.make_prefill_step(jm, jcfg, 64))(params,
                                                              _jax(batch))
    jdec = jax.jit(jax_steps.make_decode_step(jm, jcfg))
    with torch.no_grad():
        pre = steps.make_prefill_step(model, cfg, 64)(_torch(batch))
        dec = steps.make_decode_step(model, cfg)
        if cfg.family == "audio":
            np.testing.assert_allclose(pre.numpy(), np.asarray(jpre),
                                       **LOGIT_TOL)
            jenc = jm.encode(params, jnp.asarray(batch["frames"]))
            enc = model.encode(torch.from_numpy(batch["frames"]))
            tok = batch["tokens"][:, :1]
            jout, _ = jdec(params, jm.init_cache(B, 8), jnp.asarray(tok), jenc)
            out, _ = dec(model.init_cache(B, 8), torch.from_numpy(tok), enc)
        else:
            np.testing.assert_allclose(pre[0].numpy(), np.asarray(jpre[0]),
                                       **LOGIT_TOL)
            tok = np.array(jnp.argmax(jpre[0], -1), np.int32)[:, None]
            jout, _ = jdec(params, jpre[1], jnp.asarray(tok))
            out, _ = dec(pre[1], torch.from_numpy(tok))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LOGIT_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_loop_matches_jax_train_steps(jax_models, name):
    """Two ``TrainLoop`` steps (``launch/steps.py``'s train step) from the
    JAX weights on the pipeline's batches, frames and image features carried
    to the model, against two JAX train steps on the same batches: losses
    within 1e-4 and grad norms within 1e-3 relative."""
    params, arrays = jax_models(name)
    jcfg, cfg = _configs(name, flash_attention=True)
    jdata = JaxData(jcfg, B, S, seed=1)
    jstep = jax.jit(jax_steps.make_train_step(jax_build_model(jcfg)))
    p, o, jlosses, jnorms = params, jax_adamw_init(params), [], []
    for t in range(2):
        p, o, m = jstep(p, o, _jax(jdata.local_batch(t)))
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    loop = TrainLoop(cfg, global_batch=B, seq_len=S, seed=1, device="cpu",
                     init=lambda: model_from_numpy(cfg, arrays, "cpu"))
    end, state, met = loop.run(2)
    assert end == 2 and state["opt"]["step"] == 2
    np.testing.assert_allclose(met.losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(met.grad_norms, jnorms, rtol=1e-3)


# -- tests/test_archs.py's smoke runs on the port -----------------------------------------
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_smoke_forward_and_train_step(arch):
    """Forward logits of the right shape and finite; loss and gradients
    finite; one SGD step lowers the loss on the same batch."""
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = train_batch(cfg, B, S, device="cpu")
    with torch.no_grad():
        logits, _ = model.forward(batch if cfg.family in ("audio", "vlm")
                                  else batch["tokens"])
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    model.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    assert torch.isfinite(loss)
    with torch.no_grad():
        for w in model.parameters():
            assert torch.isfinite(w.grad).all()
            w -= 0.05 * w.grad
        assert model.loss(batch) < loss


@pytest.mark.parametrize("arch", [a for a in ARCHITECTURES
                                  if a not in ("whisper_tiny", "internvl2_26b")])
def test_smoke_decode(arch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 8)))
    with torch.no_grad():
        logits, cache = model.prefill(ids, max_len=16)
        assert logits.shape == (B, cfg.vocab_size)
        logits, cache = model.decode_step(cache, logits.argmax(-1)[:, None])
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_flash_route_launches_nothing_on_the_cpu():
    """On the CPU B3's wrapper runs its plain version: no launch counted."""
    cfg = dataclasses.replace(get_config("internvl2-26b", reduced=True),
                              flash_attention=True)
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    n0 = flash_attention.launches
    with torch.no_grad():
        model.forward(_torch(_numpy_batch(cfg)))
    assert flash_attention.launches == n0
