"""Kernel B3 (flash attention) of the torch port against the JAX package's
Pallas kernel, run in interpret mode on the CPU, and its blockwise reference.

On a CPU tensor the wrapper takes its plain PyTorch version; the CUDA kernel
itself is checked against that plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  Inputs are drawn with
numpy and handed to both packages; bf16 inputs are the same f32 draws
rounded to bf16 by each.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from torch_parity import keep_reference_ids  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    """``tests/test_kernels.py``'s tolerances: bf16 inputs and outputs round
    at 2^-8 of their scale; f32 sums differ only in order."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _qkv(B, S, T, K, G, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, K, G, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32))


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(t):
    return t.float().numpy()


# the shapes, masks and dtypes of tests/test_kernels.py
@pytest.mark.parametrize("S,T,K,G,hd", [
    (64, 64, 2, 3, 32), (128, 128, 1, 4, 64), (48, 96, 2, 1, 16),
    (256, 256, 4, 2, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
def test_plain_matches_pallas(S, T, K, G, hd, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, S, T, K, G, hd), dtype)
    exp = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                              q_block=32, kv_block=32, interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32),
                               **tol(dtype))


def test_plain_decode_offset_matches_pallas():
    """q_offset places the queries after S0 earlier positions."""
    B, S0, S1, K, G, hd = 1, 48, 16, 2, 2, 32
    q, k, v = _qkv(B, S0 + S1, S0 + S1, K, G, hd, seed=1)
    (jq, jk, jv), (tq, tk, tv) = _both((q[:, S0:], k, v), "float32")
    exp = flash_attention_tpu(jq, jk, jv, causal=True, q_block=16,
                              kv_block=16, interpret=True, q_offset=S0)
    got = flash_attention_plain(tq, tk, tv, causal=True, q_offset=S0)
    np.testing.assert_allclose(_np(got), np.asarray(exp), atol=2e-5)
    full = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(got, full[:, S0:], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 300])
def test_plain_matches_reference_across_blocks(dtype, window):
    """Ragged shapes past one block of 512 queries and 1024 keys, against
    ``ref.flash_attention_ref`` with the same blocks."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 600, 1100, 1, 2, 16, seed=2),
                                       dtype)
    exp = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(exp, np.float32),
                               **tol(dtype))


def test_plain_rounds_bf16_probabilities_as_the_reference():
    """The reference rounds the softmax weights to v's dtype before the
    second product; in bf16 that is visible against an f32 run, and the plain
    version shows the same difference."""
    arrays = _qkv(1, 64, 64, 1, 2, 32, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bfloat16")
    exp = np.asarray(ref.flash_attention_ref(jq, jk, jv), np.float32)
    got = _np(flash_attention_plain(tq, tk, tv))
    f32 = _np(flash_attention_plain(tq.float(), tk.float(), tv.float()))
    bf16_step = float(ml_dtypes.finfo(ml_dtypes.bfloat16).eps)
    assert np.abs(got - f32).max() > 0.1 * bf16_step
    np.testing.assert_allclose(got, exp, atol=bf16_step, rtol=bf16_step)


def test_cpu_wrapper_takes_plain_version_and_counts_nothing():
    tq, tk, tv = map(torch.from_numpy, _qkv(2, 40, 40, 2, 3, 24, seed=4))
    n0 = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, window=8),
                       flash_attention_plain(tq, tk, tv, window=8))
    assert flash_attention.launches == n0


@pytest.mark.parametrize("shapes,kw", [
    (((2, 8, 2, 3, 16), (2, 8, 3, 16), (2, 8, 3, 16)), {}),   # K differs
    (((2, 8, 2, 3, 16), (2, 8, 2, 8), (2, 8, 2, 8)), {}),     # hd differs
    (((2, 8, 2, 3, 16), (2, 8, 2, 16), (2, 9, 2, 16)), {}),   # v differs
    (((2, 8, 2, 3, 16), (2, 8, 2, 16), (2, 8, 2, 16)), {"window": 0}),
    (((2, 8, 2, 3, 16), (2, 8, 2, 16), (2, 8, 2, 16)), {"q_offset": -1}),
])
def test_wrapper_rejects_bad_arguments(shapes, kw):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)
