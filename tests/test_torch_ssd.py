"""Kernel B4 (the SSD chunked scan) of the torch port against the JAX
package: ``ssd_scan_plain`` against ``repro.models.mamba2.ssd_chunked`` (the
function the JAX model runs) and against the Pallas kernel
``ssd_scan_tpu`` in interpret mode, ``ssd_chunk_ref`` against
``repro.kernels.ref.ssd_chunk_ref``.

On a CPU tensor the wrapper ``ssd_scan`` takes its plain version; the CUDA
kernel itself is checked against that plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).  Inputs are drawn with
numpy and handed to both packages; bf16 inputs are the same f32 draws
rounded to bf16 by each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_tpu
from repro.models import mamba2 as jax_mamba2
from repro_torch.kernels.ssd_scan import (segsum, ssd_chunk_ref, ssd_scan,
                                          ssd_scan_plain)
from torch_parity import keep_reference_ids  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: tests/test_kernels.py's tolerance for the SSD scan (sums in another
# order).  bf16: both round the same f32 value of y to bf16 once, so they
# differ by one bf16 step (2^-8 to 2^-7 of |y|) where the f32 sums, taken in
# another order, fall on two sides of a rounding boundary; atol covers
# values near zero.
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=1e-2, atol=1e-3)}
# the final state is f32 in both dtypes: f32 sums in another order
STATE_TOL = dict(rtol=2e-4, atol=2e-4)

# (s, chunk, h, p, n): tests/test_kernels.py's shapes, then ragged ones
KERNEL_SHAPES = [(64, 16, 2, 8, 4), (128, 64, 4, 64, 16), (96, 32, 1, 16, 8)]
RAGGED_SHAPES = [(1000, 64, 2, 16, 8), (77, 16, 3, 8, 4), (5, 16, 1, 4, 4)]


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    # a = -softplus(normal): a log-decay, as tests/test_kernels.py draws it
    a = -np.logaddexp(0.0, rng.standard_normal((b, s, h))).astype(np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    return x, a, B, C


def _both(arrays, dtype):
    """(JAX, torch) versions; a stays f32, the others take ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    x, a, B, C = arrays
    return ([jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(B, jdt),
             jnp.asarray(C, jdt)],
            [torch.from_numpy(x).to(tdt), torch.from_numpy(a),
             torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt)])


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,h,p,n", KERNEL_SHAPES + RAGGED_SHAPES)
def test_plain_matches_ssd_chunked(s, chunk, h, p, n, dtype):
    jargs, targs = _both(_inputs(2, s, h, p, n), dtype)
    ye, he = jax_mamba2.ssd_chunked(*jargs, chunk)
    y, hlast = ssd_scan_plain(*targs, chunk)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    assert hlast.dtype == torch.float32 and hlast.shape == (2, h, p, n)
    np.testing.assert_allclose(_np(y), _np(ye), **TOL[dtype])
    np.testing.assert_allclose(_np(hlast), _np(he), **STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk,h,p,n", KERNEL_SHAPES)
def test_plain_matches_pallas_interpret(s, chunk, h, p, n, dtype):
    """The TPU kernel keeps h_prev in f32 where ``ssd_chunked`` and the port
    round it to bf16 before the ``C h_prev`` term: in bf16 the two differ by
    that rounding too, up to 2^-9 of ``sum_n |C_n h_n|``.  That sum can be
    far larger than a y that cancels, so in bf16 the absolute tolerance is
    2^-7 of y's largest magnitude instead."""
    jargs, targs = _both(_inputs(2, s, h, p, n, seed=1), dtype)
    ye, he = ssd_scan_tpu(*jargs, chunk=chunk, interpret=True)
    y, hlast = ssd_scan_plain(*targs, chunk)
    tol = TOL[dtype]
    if dtype == "bfloat16":
        tol = dict(tol, atol=2.0 ** -7 * float(np.abs(_np(ye)).max()))
    np.testing.assert_allclose(_np(y), _np(ye), **tol)
    np.testing.assert_allclose(_np(hlast), _np(he), **STATE_TOL)


def test_ragged_final_state_is_the_state_after_step_s():
    """The padded steps are identities: the state after a ragged run equals
    the state the JAX scan reaches on the same s steps, and y's first s
    steps do not depend on what follows them."""
    x, a, B, C = _inputs(2, 128, 2, 8, 4, seed=2)
    ys, hs = ssd_scan_plain(*map(torch.from_numpy, (x[:, :100], a[:, :100],
                                                    B[:, :100], C[:, :100])),
                            chunk=32)
    yf, _ = ssd_scan_plain(*map(torch.from_numpy, (x, a, B, C)), chunk=32)
    _, he = jax_mamba2.ssd_chunked(jnp.asarray(x[:, :100]),
                                   jnp.asarray(a[:, :100]),
                                   jnp.asarray(B[:, :100]),
                                   jnp.asarray(C[:, :100]), 100)
    np.testing.assert_allclose(_np(hs), _np(he), **STATE_TOL)
    np.testing.assert_allclose(_np(ys), _np(yf[:, :100]), **TOL["float32"])


def test_chunk_ref_matches_jax():
    q, h, p, n = 32, 2, 8, 4
    x, a, B, C = (arr[0] for arr in _inputs(1, q, h, p, n, seed=3))
    y_ref, st_ref = ref.ssd_chunk_ref(*map(jnp.asarray, (x, a, B, C)))
    y, st = ssd_chunk_ref(*map(torch.from_numpy, (x, a, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-5,
                               atol=1e-5)
    # one chunk of the whole scan is the chunk oracle (the JAX test's 1e-4)
    y_full, st_full = ssd_scan_plain(*(torch.from_numpy(v[None])
                                       for v in (x, a, B, C)), chunk=q)
    np.testing.assert_allclose(y.numpy(), y_full[0].numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), st_full[0].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_segsum_matches_jax():
    a = np.random.default_rng(4).standard_normal((3, 2, 10)).astype(np.float32)
    got = segsum(torch.from_numpy(a)).numpy()
    exp = np.asarray(jax_mamba2.segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(exp))
    finite = np.isfinite(exp)
    np.testing.assert_allclose(got[finite], exp[finite], rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    x, a, B, C = map(torch.from_numpy, _inputs(1, 40, 2, 8, 4, seed=5))
    n0 = ssd_scan.launches
    y, st = ssd_scan(x, a, B, C, chunk=16)
    ye, ste = ssd_scan_plain(x, a, B, C, chunk=16)
    assert torch.equal(y, ye) and torch.equal(st, ste)
    assert ssd_scan.launches == n0


@pytest.mark.parametrize("case", ["x3d", "a_shape", "bc_shape", "chunk0",
                                  "empty"])
def test_argument_checks(case):
    x, a, B, C = map(torch.from_numpy, _inputs(1, 16, 2, 8, 4, seed=6))
    args, chunk = [x, a, B, C], 8
    if case == "x3d":
        args[0] = x[0]
    elif case == "a_shape":
        args[1] = a[:, :8]
    elif case == "bc_shape":
        args[3] = C[..., :2]
    elif case == "chunk0":
        chunk = 0
    else:
        args = [t[:, :0] for t in args]
    with pytest.raises(ValueError):
        ssd_scan(*args, chunk)
