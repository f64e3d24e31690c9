"""``cfg.remat`` on the torch port: each layer body that the JAX package
wraps in ``jax.checkpoint`` runs under ``torch.utils.checkpoint`` while
autograd records (``models/layers.py`` ``remat``).

On the reduced configs of one architecture of each family, on the CPU:

* the loss and every gradient with ``remat=True`` are bitwise equal to
  ``remat=False`` (the recompute runs the same operations on the same
  inputs);
* fewer tensors are saved for the backward with it on (counted with
  ``saved_tensors_hooks``), so the wrapper is not a no-op; and B3's and
  B4's autograd Functions run their forward twice per layer, once more in
  the recompute;
* the gradients agree with the JAX package's ``jax.grad`` (``remat=True``)
  within 1e-4 of the largest reference magnitude, the loss within 1e-5
  relative, and reduced qwen2-1.5b's ``TrainLoop`` losses with the JAX
  package's ``TrainLoop`` within 1e-4 relative (``test_torch_train.py``'s
  tolerances);
* serving is untouched: ``forward`` and the prefill step under
  ``torch.no_grad()`` give the same bits with remat on and off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_grads_match

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build_model
from repro.runtime import TrainLoop as JaxTrainLoop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import D_VIS
from repro_torch.kernels.flash_attention import _FlashAttention
from repro_torch.kernels.ssd_scan import _SSDScan
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.convert import model_from_numpy
from repro_torch.runtime import TrainLoop
from torch_parity import keep_reference_ids  # noqa: F401

FAMILIES = ["qwen2-1.5b", "granite-moe-1b-a400m", "mamba2-370m", "zamba2-7b",
            "whisper-tiny", "internvl2-26b"]
B, S = 2, 32


def _cfg(name, remat, api=get_config):
    return dataclasses.replace(api(name, reduced=True), remat=remat,
                               flash_attention=True)


def _model(name, remat):
    """The port's model of ``name`` with weights drawn from one seed."""
    cfg = _cfg(name, remat)
    return build_model(cfg).init(torch.Generator().manual_seed(0)), cfg


def _numpy_batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vis"] = rng.standard_normal(
            (B, cfg.vis_tokens, D_VIS)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(name, remat):
    """Loss, gradients by name, and the number of tensors saved for the
    backward, of one forward and backward."""
    model, cfg = _model(name, remat)
    model.requires_grad_(True)
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss(_torch(_numpy_batch(cfg)))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.detach(), grads, saved[0]


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_loss_and_gradients_bitwise_equal(name):
    loss_on, grads_on, _ = _loss_and_grads(name, True)
    loss_off, grads_off, _ = _loss_and_grads(name, False)
    assert torch.equal(loss_on, loss_off)
    assert sorted(grads_on) == sorted(grads_off)
    for k, g in grads_off.items():
        assert g is not None, k
        assert torch.equal(grads_on[k], g), k


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_saves_fewer_tensors(name):
    _, _, saved_on = _loss_and_grads(name, True)
    _, _, saved_off = _loss_and_grads(name, False)
    assert saved_on < saved_off


def _counted_forwards(monkeypatch, fn_cls):
    calls = [0]
    forward = fn_cls.forward

    def counted(ctx, *args):
        calls[0] += 1
        return forward(ctx, *args)

    monkeypatch.setattr(fn_cls, "forward", staticmethod(counted))
    return calls


@pytest.mark.parametrize("name,fn_cls", [("qwen2-1.5b", _FlashAttention),
                                         ("mamba2-370m", _SSDScan)])
@pytest.mark.parametrize("remat", [False, True])
def test_recompute_runs_the_kernel_forward_again(monkeypatch, name, fn_cls,
                                                 remat):
    """B3's (B4's) autograd Function runs once per layer in the forward and,
    with remat, once more per layer in the backward's recompute: the
    launches the card counts per training step."""
    calls = _counted_forwards(monkeypatch, fn_cls)
    model, cfg = _model(name, remat)
    loss = model.requires_grad_(True).loss(_torch(_numpy_batch(cfg)))
    assert calls[0] == cfg.num_layers
    loss.backward()
    assert calls[0] == cfg.num_layers * (2 if remat else 1)


@pytest.fixture(scope="module")
def jax_models():
    """(JAX params, numpy copy) of each reduced config with remat on."""
    cache = {}

    def get(name):
        if name not in cache:
            params = jax_build_model(_cfg(name, True, jax_config)).init(
                jax.random.PRNGKey(0))
            cache[name] = (params, jax.tree.map(np.array, params))
        return cache[name]

    return get


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_match_jax(jax_models, name):
    """Both packages with remat on, from the JAX weights: loss within 1e-5
    relative, each gradient within 1e-4 of its largest reference
    magnitude."""
    params, arrays = jax_models(name)
    jcfg, cfg = _cfg(name, True, jax_config), _cfg(name, True)
    batch = _numpy_batch(cfg, seed=7)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = model_from_numpy(cfg, arrays, "cpu").requires_grad_(True)
    loss = model.loss(_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_grads_match(model, jgrads, cfg.family)


def test_remat_train_loop_losses_match_jax(jax_models):
    """Three steps of both packages' TrainLoops, remat on, from the same
    weights on the same batches: losses within 1e-4 relative."""
    name = "qwen2-1.5b"
    _, arrays = jax_models(name)
    jcfg, cfg = _cfg(name, True, jax_config), _cfg(name, True)
    kw = dict(global_batch=4, seq_len=32, seed=0)
    _, _, jm = JaxTrainLoop(jcfg, **kw).run(3)
    loop = TrainLoop(cfg, **kw, device="cpu",
                     init=lambda: model_from_numpy(cfg, arrays, "cpu"))
    end, _, m = loop.run(3)
    assert end == 3
    np.testing.assert_allclose(m.losses, jm.losses, rtol=1e-4)


def _serve_outputs(name, remat):
    """``forward`` and the prefill step under ``no_grad``, flattened."""
    model, cfg = _model(name, remat)
    batch = _torch(_numpy_batch(cfg))
    with torch.no_grad():
        fwd = model.forward(batch if cfg.family in ("audio", "vlm")
                            else batch["tokens"])
        pre = steps.make_prefill_step(model, cfg, 64)(batch)
    out = []
    for x in (fwd, pre):
        stack = [x]
        while stack:
            y = stack.pop()
            if isinstance(y, torch.Tensor):
                out.append(y)
            elif isinstance(y, (tuple, list)):
                stack.extend(y)
            elif isinstance(y, dict):
                stack.extend(y[k] for k in sorted(y))
            else:
                out.append(torch.tensor(y))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_serving_untouched_by_remat(name):
    on, off = _serve_outputs(name, True), _serve_outputs(name, False)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
