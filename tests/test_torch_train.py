"""The torch port's training slice held against the JAX package on the CPU.

Kernel B3's backward (the plain blockwise backward behind its autograd
Function) and its ``lse`` against ``jax.grad`` through
``repro.kernels.ref.flash_attention_ref``; the data pipeline, AdamW,
gradient compression and the checkpoint store against their JAX twins;
reduced qwen2-1.5b's loss, gradients and ``TrainLoop`` losses against the
JAX model's from the same weights and batches; restart and elastic
recovery as in ``tests/test_runtime_macro.py``; the launcher on the CPU.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.data import SyntheticLMData as JaxData
from repro.kernels import ref
from repro.launch.inputs import train_batch as jax_train_batch
from repro.models import DecoderLM as JaxDecoderLM
from repro.models import layers as JL
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compress_grads as jax_compress_grads
from repro.runtime import TrainLoop as JaxTrainLoop
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import Prefetcher, SyntheticLMData
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.inputs import train_batch
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import layers as L
from repro_torch.models.convert import model_from_numpy
from repro_torch.optim import (adamw_init, adamw_update, compress_grads,
                               compression_ratio, decompress_grads)
from repro_torch.runtime import ElasticTrainer, TrainLoop, rebalance_weights
from torch_parity import keep_reference_ids  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"


def _rel(got, exp):
    """Largest difference relative to the largest reference magnitude."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


# -- B3: lse and the blockwise backward -----------------------------------------
# the shapes of tests/test_kernels.py, a key count past one 1024-key block and
# a query count past one 512-query block; causal, window and non-causal
FLASH_SHAPES = [(64, 64, 2, 3, 32), (128, 128, 1, 4, 64), (48, 96, 2, 1, 16),
                (256, 256, 4, 2, 128), (600, 1100, 2, 2, 16)]


@pytest.mark.parametrize("S,T,K,G,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
def test_flash_gradients_and_lse_match_jax(S, T, K, G, hd, causal, window):
    """f32: dq, dk, dv within 1e-4 of the largest reference magnitude, and
    lse within 1e-4 of it, for the same numpy inputs."""
    rng = np.random.default_rng(S * 7 + T)
    B = 2
    q = rng.standard_normal((B, S, K, G, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, K, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, K, hd), dtype=np.float32)
    dout = rng.standard_normal((B, S, K, G, hd), dtype=np.float32)

    def f(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window) * dout)

    jg = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    _, jlse = ref._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, window, 512, 1024, 0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal, window=window,
                               return_lse=True)
    (out * torch.from_numpy(dout)).sum().backward()
    for name, exp, got in zip("qkv", jg, (tq.grad, tk.grad, tv.grad)):
        assert _rel(got.numpy(), exp) <= 1e-4, name
    assert _rel(lse.detach().numpy(), jlse) <= 1e-4


def test_flash_lse_without_grad_matches_with_grad():
    """The direct call (no autograd) gives the Function's out and lse, and
    the launch path stays the inference one when nothing requires grad."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 40, 2, 3, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 16), dtype=np.float32))
    out, lse = flash_attention(q, k, k, return_lse=True)
    out2, lse2 = flash_attention(q.requires_grad_(), k, k, return_lse=True)
    assert out2.requires_grad and not lse2.requires_grad
    assert torch.equal(out, out2.detach()) and torch.equal(lse, lse2)
    assert torch.equal(flash_attention(q.detach(), k, k), out)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (None, mask):
        exp = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)


# -- data -----------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny", "internvl2-26b"])
def test_synthetic_data_bitwise_equal_to_jax(arch):
    """A batch is a pure function of (seed, step, dp_rank): the same bits as
    the JAX package's, frames and image features included."""
    jd = JaxData(jax_config(arch, reduced=True), 8, 16, seed=3)
    td = SyntheticLMData(get_config(arch, reduced=True), 8, 16, seed=3)
    for step, rank, size in ((0, 0, 1), (5, 1, 4), (9, 3, 4)):
        a, b = jd.local_batch(step, rank, size), td.local_batch(step, rank, size)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_prefetcher_overlap_and_order():
    d = SyntheticLMData(get_config(ARCH, reduced=True), 4, 8)
    pf = Prefetcher(d, start_step=7, depth=2)
    s0, b0 = pf.next()
    s1, _ = pf.next()
    pf.stop()
    assert (s0, s1) == (7, 8)
    np.testing.assert_array_equal(b0["tokens"], d.local_batch(7)["tokens"])


def test_train_batch_matches_jax():
    cfg = get_config(ARCH, reduced=True)
    a = jax_train_batch(jax_config(ARCH, reduced=True), 2, 9,
                        rng=np.random.default_rng(4))
    b = train_batch(cfg, 2, 9, rng=np.random.default_rng(4), device="cpu")
    np.testing.assert_array_equal(np.asarray(a["tokens"]), b["tokens"].numpy())
    assert b["labels"] is b["tokens"]


# -- optimizer ------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "b": (rng.standard_normal((17,)) * scale).astype(np.float32),
            "e": (rng.standard_normal((5, 3, 4)) * scale).astype(np.float32)}


@pytest.mark.parametrize("gscale", [0.01, 10.0])
def test_adamw_update_matches_jax(gscale):
    """Three updates, unclipped (0.01) and clipped (10): parameters and
    moments within 1e-6 of each leaf's largest reference magnitude, the
    grad norm within 1e-6 relative.  (The two sum the squares for the norm
    in other orders, so the clip scale differs in its last bits; a moment
    near 0, where b1 m and (1 - b1) g cancel, then differs by more than
    1e-6 of itself.)"""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp, js = params, jax_adamw_init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw_init(tp)
    assert ts["step"] == 0 and all(m.dtype == torch.float32
                                   for m in ts["m"].values())
    for _ in range(3):
        grads = _tree(rng, gscale)
        jp, js, jgn = jax_adamw_update(jp, grads, js, lr=1e-2)
        tp, ts, tgn = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts, lr=1e-2)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 3
    for k in params:
        assert _rel(tp[k].numpy(), jp[k]) <= 1e-6, k
        assert _rel(ts["m"][k].numpy(), js["m"][k]) <= 1e-6, k
        assert _rel(ts["v"][k].numpy(), js["v"][k]) <= 1e-6, k


def test_compress_grads_matches_jax_with_error_feedback():
    """int8 codes and scales equal to the JAX package's; the round trip is
    within 1% of each leaf's scale; error feedback carries the residual."""
    rng = np.random.default_rng(0)
    grads = {"w": rng.normal(size=(300,)).astype(np.float32) * 0.01,
             "b": rng.normal(size=(7,)).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jcomp, jerr = jax_compress_grads({k: jnp.asarray(v) for k, v in grads.items()})
    comp, err = compress_grads(tg)
    assert comp["keys"] == sorted(grads)
    for i, k in enumerate(comp["keys"]):
        np.testing.assert_array_equal(comp["q"][i].numpy(), np.asarray(jcomp["q"][i]))
        np.testing.assert_allclose(comp["s"][i].numpy(), np.asarray(jcomp["s"][i]),
                                   rtol=1e-6)
        np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                   rtol=1e-5, atol=1e-9)
    out = decompress_grads(comp)
    for k in grads:
        assert np.abs(out[k].numpy() - grads[k]).max() <= np.abs(grads[k]).max() / 100
    comp2, _ = compress_grads(tg, err)
    recovered = decompress_grads(comp2)
    err_a = np.abs(out["w"].numpy() - grads["w"]).mean()
    two = (out["w"].numpy() + recovered["w"].numpy()) / 2
    assert np.abs(two - grads["w"]).mean() <= err_a * 1.01
    assert compression_ratio(tg) < 0.3


# -- checkpoint store ------------------------------------------------------------
def _ckpt_tree():
    return {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4)),
                                          "d": np.int32(7)},
            "step": 4}


def test_checkpoint_roundtrip_restores_types(tmp_path):
    tree = _ckpt_tree()
    save_checkpoint(tmp_path, 42, tree, num_shards=2)
    assert latest_step(tmp_path) == 42
    assert sorted(p.name for p in (tmp_path / "step_000042").iterdir()) == [
        "MANIFEST.json", "shard_00000.npz", "shard_00001.npz"]
    step, out = restore_checkpoint(tmp_path, tree)
    assert step == 42 and out["step"] == 4 and isinstance(out["step"], int)
    assert isinstance(out["a"], torch.Tensor) and torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert int(out["b"]["d"]) == 7


def test_checkpoint_layout_interchanges_with_jax(tmp_path):
    """The port's step directory is the JAX package's: each restores what
    the other saved, leaf for leaf."""
    tree = _ckpt_tree()
    save_checkpoint(tmp_path / "t", 3, tree)
    like = jax.tree.map(np.asarray, {"a": np.zeros(10, np.float32),
                                     "b": {"c": np.zeros((3, 4), np.float32),
                                           "d": np.int32(0)},
                                     "step": np.int64(0)})
    step, out = jax_restore_checkpoint(tmp_path / "t", like)
    assert step == 3
    np.testing.assert_array_equal(out["a"], tree["a"].numpy())
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"].numpy())
    jax_save_checkpoint(tmp_path / "j", 5, {k: v for k, v in like.items()})
    step, back = restore_checkpoint(tmp_path / "j", tree)
    assert step == 5 and torch.equal(back["a"], torch.zeros(10))


def test_checkpoint_atomicity(tmp_path):
    """A step dir without its COMMITTED marker must be invisible."""
    save_checkpoint(tmp_path, 10, {"a": torch.arange(4.0)})
    (tmp_path / "step_000020").mkdir()          # torn save: no marker
    assert latest_step(tmp_path) == 10


def test_checkpoint_manager_async(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=5, keep=2, async_save=True)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)))
    for step in (5, 10, 15):
        assert mgr.should_save(step)
        saved = w.clone()
        mgr.save(step, {"w": w})
        w.add_(1.0)                 # the snapshot was taken before this
    mgr.wait()
    assert mgr.latest == 15
    committed = sorted(p.name for p in tmp_path.glob("COMMITTED_*"))
    assert len(committed) == 2
    _, out = restore_checkpoint(tmp_path, {"w": w})
    assert torch.equal(out["w"], saved)


def test_checkpoint_manager_close_joins_inflight_save(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=1, keep=3, async_save=True)
    tree = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(256, 64)))}
    mgr.save(5, tree)
    assert mgr.close() is None
    assert mgr._thread is None
    assert mgr.latest == 5
    (tmp_path / "step_000007").write_text("not a directory")
    mgr.save(7, tree)
    err = mgr.close()
    assert err is not None
    assert mgr.close() is None
    mgr.save(9, tree)
    mgr.wait()
    assert mgr.latest == 9


def test_rebalance_weights():
    w = rebalance_weights({"device.0": 0.001, "device.1": 0.004,
                           "host": 0.01})
    assert set(w) == {"device.0", "device.1"}
    assert w["device.0"] > w["device.1"]
    assert abs(sum(w.values()) - 2.0) < 1e-6


# -- reduced qwen2-1.5b against the JAX model -------------------------------------
@pytest.fixture(scope="module")
def jax_params():
    params = JaxDecoderLM(jax_config(ARCH, reduced=True)).init(
        jax.random.PRNGKey(0))
    return params, jax.tree.map(np.array, params)


def _cfgs(flash):
    return (dataclasses.replace(jax_config(ARCH, reduced=True),
                                flash_attention=flash),
            dataclasses.replace(get_config(ARCH, reduced=True),
                                flash_attention=flash))


def _batch(vocab, B=2, S=48, seed=5):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)
    return toks


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_gradients_match_jax(jax_params, flash):
    """Loss within 1e-5 relative; each parameter's gradient within 1e-4 of
    its largest reference magnitude."""
    params, np_params = jax_params
    jcfg, cfg = _cfgs(flash)
    toks = _batch(cfg.vocab_size)
    jm = JaxDecoderLM(jcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    model = model_from_numpy(cfg, np_params, "cpu").requires_grad_(True)
    t = torch.from_numpy(toks)
    loss = model.loss({"tokens": t, "labels": t})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = dict(model.named_parameters())
    top = {k: v for k, v in jgrads.items() if k != "layers"}
    for name, g in jax.tree_util.tree_flatten_with_path(top)[0]:
        key = ".".join(str(getattr(p, "key", p)) for p in name)
        assert _rel(grads["params." + key].grad.numpy(), g) <= 1e-4, key
        assert grads["params." + key].grad.shape == g.shape
    for i in range(cfg.num_layers):
        layer = jax.tree.map(lambda a: np.asarray(a)[i], jgrads["layers"])
        for name, g in jax.tree_util.tree_flatten_with_path(layer)[0]:
            key = ".".join(str(getattr(p, "key", p)) for p in name)
            got = grads[f"layers.{i}.{key}"].grad.numpy()
            assert _rel(got, g) <= 1e-4, (i, key)


def test_train_step_and_serving_steps(jax_params):
    """One train step through ``make_train_step`` equals the JAX step's loss
    and grad norm; the prefill and decode steps are the model's own."""
    params, np_params = jax_params
    jcfg, cfg = _cfgs(True)
    toks = _batch(cfg.vocab_size)
    from repro.launch.steps import make_train_step as jax_make_train_step
    _, _, jm = jax_make_train_step(JaxDecoderLM(jcfg))(
        params, jax_adamw_init(params),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    model = model_from_numpy(cfg, np_params, "cpu").requires_grad_(True)
    tp = dict(model.named_parameters())
    t = torch.from_numpy(toks)
    _, opt, m = make_train_step(model)(tp, adamw_init(tp),
                                       {"tokens": t, "labels": t})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert opt["step"] == 1 and all(p.grad is None for p in tp.values())
    with torch.no_grad():
        logits, cache = make_prefill_step(model, cfg, 64)({"tokens": t})
        exp_logits, _ = model.prefill(t, 64)
        assert torch.equal(logits, exp_logits)
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_logits, _ = make_decode_step(model, cfg)(cache, nxt)
        assert step_logits.shape == (2, cfg.vocab_size)


def _loop_pair(np_params, flash):
    jcfg, cfg = _cfgs(flash)
    kw = dict(global_batch=4, seq_len=32, seed=0)
    return (JaxTrainLoop(jcfg, **kw),
            TrainLoop(cfg, **kw, device="cpu",
                      init=lambda: model_from_numpy(cfg, np_params, "cpu")))


@pytest.mark.parametrize("flash", [False, True])
def test_train_loop_losses_match_jax(jax_params, flash):
    """Three steps of both packages' TrainLoops from the same weights on the
    same batches: losses within 1e-4 relative."""
    _, np_params = jax_params
    jloop, loop = _loop_pair(np_params, flash=flash)
    _, _, jm = jloop.run(3)
    end, state, m = loop.run(3)
    assert end == 3 and m.steps == [0, 1, 2]
    np.testing.assert_allclose(m.losses, jm.losses, rtol=1e-4)
    assert state["opt"]["step"] == 3
    assert 0.0 <= loop.overlap <= 1.0


def test_train_loop_loss_decreases(tmp_path):
    loop = TrainLoop(get_config(ARCH, reduced=True), global_batch=4,
                     seq_len=32, ckpt_dir=tmp_path / "ck", ckpt_interval=10,
                     device="cpu")
    end, _, m = loop.run(12)
    assert end == 12 and len(m.losses) == 12
    assert m.losses[-1] < m.losses[0], m.losses
    assert latest_step(tmp_path / "ck") == 10


def _fresh(ckdir):
    return TrainLoop(get_config(ARCH, reduced=True), global_batch=4,
                     seq_len=32, ckpt_dir=ckdir, ckpt_interval=4, seed=0,
                     device="cpu")


def test_checkpoint_restart_resumes_exactly(tmp_path):
    """Train 8 steps with a crash at step 5 -> restart -> the same losses and
    parameters, bit for bit, as an uninterrupted 8-step run."""
    _, ref_state, ref_m = _fresh(tmp_path / "ref").run(8)
    loop = _fresh(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        loop.run(8, fail_at=5)
    loop2 = _fresh(tmp_path / "ck")
    start, state = loop2.restore_or_init()
    assert start == 5
    end, state, m = loop2.run(8 - start, start_step=start, state=state)
    assert end == 8
    assert m.losses == ref_m.losses[5:]
    for k, p in state["params"].items():
        assert torch.equal(p, ref_state["params"][k]), k
        assert torch.equal(state["opt"]["m"][k], ref_state["opt"]["m"][k]), k


def test_elastic_trainer_survives_failure(tmp_path):
    calls = []

    def make_loop(world_size):
        calls.append(world_size)
        return TrainLoop(get_config(ARCH, reduced=True), global_batch=4,
                         seq_len=32, ckpt_dir=tmp_path / "ck",
                         ckpt_interval=3, seed=0, device="cpu")

    state, metrics, world = ElasticTrainer(make_loop).run(10, world_size=4,
                                                          fail_at=7)
    assert metrics.restarts == 1
    assert world == 3
    assert calls == [4, 3]
    assert max(metrics.steps) == 9
    # steps 0-6 before the checkpoint at 6, then 7-9 after the restart
    assert state["opt"]["step"] == 10


def test_train_loop_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainLoop(get_config(ARCH, reduced=True), global_batch=2, seq_len=8)


def test_launcher_trains_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` exits 0, and the
    run loads neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.launch.train import main; "
         "main(sys.argv[1:]); "
         "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
         "assert not bad, bad",
         "--steps", "3", "--batch", "2", "--seq", "16", "--flash",
         "--device", "cpu", "--ckpt", str(tmp_path / "ck"),
         "--ckpt-interval", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[train] loss" in r.stdout and "flash=True" in r.stdout
    assert latest_step(tmp_path / "ck") == 2
