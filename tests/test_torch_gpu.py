"""Tests of the torch port that need a CUDA card; each skips without one.

Run on a machine with the card (no JAX needed there):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import copy
import dataclasses
import gc
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.apps import (NBody, WaveSim, body_energies, run_nbody,
                              run_rsim, run_wave, serve_simulations)
from repro_torch.configs import get_config
from repro_torch.core import (Box, ExecutionAborted, FaultPlan, Runtime,
                              ServingRuntime, all_range, neighborhood,
                              one_to_one, read, read_write, reduction, write)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import build_model
from repro_torch.kernels.nbody import (nbody_forces_rows,
                                       nbody_forces_rows_plain)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_plain,
                                          ssd_state_pass,
                                          ssd_state_pass_plain)
from repro_torch.kernels.stencil5 import (halo_rows, wave_step_rows,
                                          wave_step_rows_plain)
from repro_torch.runtime import ServeLoop, TrainLoop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _term_magnitudes(p, lo, hi, soft=1e-3):
    """``sum_j |d_ij| / r_ij^3`` per row and component: the scale of the
    rounding error of an f32 sum of the force terms, whatever its order."""
    pa = p.float()
    d = pa[None, :, :] - pa[lo:hi, None, :]
    w = torch.rsqrt((d * d).sum(-1) + soft) ** 3
    return (d.abs() * w[..., None]).sum(1)


def _splits(N, seed):
    """Row ranges [lo, hi) of N: halves, thirds, single rows at both ends,
    and ranges cut at random points (none on a 64-row block boundary by
    design)."""
    rng = np.random.default_rng(seed)
    cuts = sorted(int(c) for c in rng.integers(1, N, size=6))
    edges = [0, *cuts, N]
    return [(0, N), (0, N // 3), (N // 3, N), (0, 1), (N - 1, N),
            *zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1000, 5000])
def test_nbody_kernel_matches_plain(cuda, dtype, N):
    """Each split's rows are bitwise those of the full-range launch: a row's
    sum order depends on N alone.  N = 5000 has full tiles and a ragged
    one."""
    p = _randn(N, 3, seed=7).to(cuda, dtype)
    full = nbody_forces_rows(p, 0, N)
    for lo, hi in _splits(N, seed=N):
        got = nbody_forces_rows(p, lo, hi)
        err = (got - nbody_forces_rows_plain(p, lo, hi)).abs().float()
        # f32 sums of N terms in two orders: relative to the terms' scale
        assert (err <= 1e-6 + 1e-4 * _term_magnitudes(p, lo, hi)).all()
        assert torch.equal(got, full[lo:hi]), (lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wave_kernel_matches_plain(cuda, dtype):
    H, W = 1000, 777
    um = _randn(H, W, seed=8).to(cuda, dtype)
    u = _randn(H, W, seed=9).to(cuda, dtype)
    whole = wave_step_rows(um, u, 0, H)
    torch.testing.assert_close(whole, wave_step_rows_plain(um, u, 0, H),
                               rtol=1e-5, atol=1e-5)
    parts = []
    for lo, hi in [(0, 1), (1, 250), (250, 999), (999, 1000)]:
        top, bottom = halo_rows(lo, hi - lo, H)
        parts.append(wave_step_rows(um[lo:hi], u[lo - top:hi + bottom], lo, H))
    assert torch.equal(torch.cat(parts), whole)


def test_wrappers_count_launches_and_reject_strided_input(cuda):
    p = _randn(64, 3, seed=10).to(cuda)
    n0 = nbody_forces_rows.launches
    nbody_forces_rows(p, 0, 64)
    nbody_forces_rows(p, 5, 5)                  # nothing to launch
    assert nbody_forces_rows.launches == n0 + 1
    with pytest.raises(ValueError):
        nbody_forces_rows(_randn(3, 64, seed=11).to(cuda).t(), 0, 64)
    with pytest.raises(TypeError):
        nbody_forces_rows(p.half(), 0, 64)


def test_runtime_runs_match_runtime_free_runs(cuda):
    rng = np.random.default_rng(12)
    P0 = rng.standard_normal((2048, 3), dtype=np.float32)
    V0 = rng.standard_normal((2048, 3), dtype=np.float32) * 0.1
    u0 = rng.standard_normal((300, 200), dtype=np.float32)
    u1 = rng.standard_normal((300, 200), dtype=np.float32)
    with Runtime(2, 2) as rt:
        P = run_nbody(rt, P0, V0, 4, 1e-3, 1e-3)
        F = run_wave(rt, u0, u1, 7)
    p, v = torch.from_numpy(P0).to(cuda), torch.from_numpy(V0).to(cuda)
    for _ in range(4):
        v = v + 1e-3 * nbody_forces_rows(p, 0, 2048) * 1e-3
        p = p + v * 1e-3
    um, u = torch.from_numpy(u0).to(cuda), torch.from_numpy(u1).to(cuda)
    for _ in range(7):
        um, u = u, wave_step_rows(um, u, 0, 300)
    np.testing.assert_array_equal(P, p.cpu().numpy())
    np.testing.assert_array_equal(F, u.cpu().numpy())


# tests/test_kernels.py's tolerances: sums in other orders; in bf16 both
# round the softmax weights to bf16, relative to different running maxima
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


# (S, T, K, G, hd): hd in {16, 24, 32, 80, 112, 128}; S * G not a multiple of
# the bf16 kernel's 128-row blocks; T not a multiple of its 128-key tiles;
# G = 1 (zamba2-7b's shared block has hd 112 and G 1); then the model shapes
# of the granite-moe configs (hd 64, K 8, G 2 and 3, a 2048-token prefill)
# and of InternVL (hd 128, K 8, G 6, 256 image + 1024 text tokens)
FLASH_MODEL_SHAPES = [(2048, 2048, 8, 2, 64), (2048, 2048, 8, 3, 64),
                      (1280, 1280, 8, 6, 128)]
FLASH_SHAPES = [(64, 64, 2, 3, 32), (100, 130, 2, 6, 80), (200, 200, 1, 4, 128),
                (48, 96, 2, 1, 16), (77, 77, 2, 5, 24), (300, 333, 1, 1, 112),
                (257, 300, 2, 6, 128), *FLASH_MODEL_SHAPES]
# B3's gradients under autograd against autograd through the einsum route
# at the model shapes: f32 1e-4 of the largest magnitude (sums in other
# orders); bf16 5e-2, chip_smoke.py's FLASH_GRAD_BF16_TOL (the einsum route
# rounds the logits, the weights and every product to bf16)
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,K,G,hd", FLASH_SHAPES)
# windows smaller than one key tile (32) and larger (200)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (True, 200), (False, None)])
def test_flash_kernel_matches_plain(cuda, dtype, S, T, K, G, hd, causal,
                                    window):
    q = _randn(2, S, K, G, hd, seed=13).to(cuda, dtype)
    k = _randn(2, T, K, hd, seed=14).to(cuda, dtype)
    v = _randn(2, T, K, hd, seed=15).to(cuda, dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    exp = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), exp.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,G,hd,window", [(64, 16, 2, 32, None),
                                             (300, 100, 6, 128, None),
                                             (333, 77, 1, 112, None),
                                             (300, 130, 3, 80, 96)])
def test_flash_kernel_decode_offset(cuda, dtype, T, S, G, hd, window):
    """The last S of T query positions at q_offset T - S (T > S) against the
    whole run's rows."""
    q = _randn(1, T, 2, G, hd, seed=16).to(cuda, dtype)
    k = _randn(1, T, 2, hd, seed=17).to(cuda, dtype)
    v = _randn(1, T, 2, hd, seed=18).to(cuda, dtype)
    part = flash_attention(q[:, T - S:].contiguous(), k, v, window=window,
                           q_offset=T - S)
    full = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(part.float(), full[:, T - S:].float(),
                               **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,K,G,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)])
def test_flash_kernel_lse_matches_plain(cuda, dtype, S, T, K, G, hd, causal,
                                        window):
    """B3's lse from its epilogue against the plain version's (f32 in both
    dtypes: the logits are exact f32 products of the same inputs, so only
    the order of the sums and ex2's 2 ulp differ); the output is bit for bit
    the launch without lse."""
    q = _randn(2, S, K, G, hd, seed=31).to(cuda, dtype)
    k = _randn(2, T, K, hd, seed=32).to(cuda, dtype)
    v = _randn(2, T, K, hd, seed=33).to(cuda, dtype)
    out, lse = flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)
    _, exp = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, K, G, S)
    torch.testing.assert_close(lse, exp, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            window=window))


@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("window", [None, 32])
def test_flash_gradients_on_card_match_cpu(cuda, G, window):
    """f32: the Function's gradients on the card (B3 forward with lse, the
    plain backward) within 1e-4 of the largest of the CPU's."""
    shapes = ((2, 200, 2, G, 64), (2, 200, 2, 64), (2, 200, 2, 64))
    cpu = [_randn(*sh, seed=40 + i).requires_grad_() for i, sh in
           enumerate(shapes)]
    card = [t.detach().to(cuda).requires_grad_() for t in cpu]
    dout = _randn(*shapes[0], seed=44)
    n0 = flash_attention.launches
    for args, d in ((cpu, dout), (card, dout.to(cuda))):
        (flash_attention(*args, window=window) * d).sum().backward()
    assert flash_attention.launches == n0 + 1
    for a, b in zip(cpu, card):
        assert (b.grad.cpu() - a.grad).abs().max() <= 1e-4 * a.grad.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,K,G,hd", FLASH_MODEL_SHAPES)
def test_flash_gradients_at_model_shapes_match_einsum(cuda, dtype, S, T, K,
                                                      G, hd):
    from repro_torch.models.layers import _sdpa, causal_mask
    base = [_randn(1, S, K, G, hd, seed=45), _randn(1, T, K, hd, seed=46),
            _randn(1, T, K, hd, seed=47)]
    dout = _randn(1, S, K, G, hd, seed=48).to(cuda, dtype)
    mask = causal_mask(S, T, device=cuda)
    grads = []
    for route in ("kernel", "einsum"):
        qkv = [t.to(cuda, dtype).requires_grad_() for t in base]
        out = flash_attention(*qkv) if route == "kernel" else _sdpa(*qkv, mask)
        (out.float() * dout.float()).sum().backward()
        grads.append([t.grad.float() for t in qkv])
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= FLASH_GRAD_TOL[dtype] * b.abs().max()


def test_records_carry_card_time(cuda):
    """A device lane's record is the card's interval inside the host's: a
    kernel that sleeps on the card for about 2 ms lasts that long in its
    record, and the lane's host interval brackets it."""
    with Runtime(1, 1, trace=True, device="cuda") as rt:
        X = rt.buffer((4,), init=np.zeros(4), name="X")

        def spin(chunk, xv):
            torch.cuda._sleep(2_000_000)
            xv.set(chunk, xv.get(chunk) + 1)

        for i in range(3):
            rt.submit(f"spin{i}", (4,), [read_write(X, one_to_one())], spin)
        rt.sync()
        recs = [r for r in rt.tracer.records if r.kind == "device_kernel"]
    assert len(recs) == 3
    for r in recs:
        assert r.t_ready <= r.t_start <= r.t_done
        assert r.t_host_start - 2e-4 <= r.t_start
        assert r.t_done <= r.t_host_done + 2e-4
        assert r.t_done - r.t_start > 1e-4


def test_spans_mode_stamps_launch_and_sync_without_gates(cuda):
    """``trace="spans"`` gates and times nothing on the card: a kernel that
    sleeps about 5 ms on the card returns from its launch at once, and its
    lane waits for it in ``lane.sync``."""
    with Runtime(1, 1, trace="spans", device="cuda") as rt:
        X = rt.buffer((4,), init=np.zeros(4), name="X")

        def spin(chunk, xv):
            torch.cuda._sleep(10_000_000)
            xv.set(chunk, xv.get(chunk) + 1)

        for i in range(3):
            rt.submit(f"spin{i}", (4,), [read_write(X, one_to_one())], spin)
        out = rt.gather(X)
        ex = rt.executors[0]
        assert ex.backend.clock is None
        assert all(q._work == q._run_stamped
                   for qs in ex.backend.device_queues for q in qs)
        assert sum(ex.card_gates.values()) == 0
        recs = [r for r in rt.tracer.records if r.kind == "device_kernel"]
    np.testing.assert_array_equal(out, np.full(4, 3.0))
    assert len(recs) == 3
    for r in recs:
        assert not r.on_card
        assert (r.t_ready <= r.t_start <= r.t_launched <= r.t_synced
                <= r.t_done)
        assert r.t_synced - r.t_launched > 2e-3
    last = recs[-1]
    assert last.t_launched - last.t_start < last.t_synced - last.t_launched


def test_card_records_leave_host_time_out(cuda):
    """The gate holds the lane's stream until the item has queued all of
    its work: an item that sleeps 20 ms on the host between two small card
    operations lasts microseconds on the card and over 20 ms on the host."""
    import time
    with Runtime(1, 1, trace=True, device="cuda") as rt:
        X = rt.buffer((1024,), init=np.zeros(1024), name="X")

        def slow_host(chunk, xv):
            y = xv.get(chunk) + 1
            time.sleep(0.02)
            xv.set(chunk, y * 2)

        for i in range(3):
            rt.submit(f"slow{i}", (1024,), [read_write(X, one_to_one())],
                      slow_host)
        out = rt.gather(X)
        recs = [r for r in rt.tracer.records if r.kind == "device_kernel"
                and r.name.startswith("slow")]
        gates = rt.executors[0].card_gates
    np.testing.assert_array_equal(out, np.full(1024, 14.0))
    assert len(recs) == 3 and gates["expired"] == 0 and gates["held"] >= 3
    for r in recs:
        assert r.on_card
        assert r.t_host_done - r.t_host_start >= 0.02
        assert r.t_done - r.t_start < 2e-3


def test_card_gate_gives_up_on_an_item_that_waits_for_its_stream(cuda):
    """An item that synchronises with its own stream before the gate opens
    is delayed by the gate's timeout, not hung, and is counted."""
    with Runtime(1, 1, trace=True, device="cuda") as rt:
        X = rt.buffer((8,), init=np.zeros(8), name="X")

        def syncs(chunk, xv):
            xv.set(chunk, xv.get(chunk) + 1)
            torch.cuda.current_stream().synchronize()

        rt.submit("syncs", (8,), [read_write(X, one_to_one())], syncs)
        out = rt.gather(X)
        gates = rt.executors[0].card_gates
    np.testing.assert_array_equal(out, np.ones(8))
    assert gates["expired"] == 1


def test_train_loop_on_card_matches_cpu(cuda):
    """Reduced qwen2-1.5b (f32, B3 on): three TrainLoop steps on the card
    give the CPU's losses within 1e-4 relative from the same weights."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              flash_attention=True)
    base = build_model(cfg).init(torch.Generator().manual_seed(22))
    losses = []
    for dev in ("cpu", cuda):
        loop = TrainLoop(cfg, global_batch=2, seq_len=64, device=dev,
                         init=lambda dev=dev: copy.deepcopy(base).to(dev))
        losses.append(loop.run(3)[2].losses)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_flash_wrapper_counts_launches_and_rejects_what_it_cannot_take(cuda):
    q = _randn(1, 8, 1, 2, 16, seed=19).to(cuda)
    k = _randn(1, 8, 1, 16, seed=20).to(cuda)
    n0 = flash_attention.launches
    flash_attention(q, k, k)
    assert flash_attention.launches == n0 + 1
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):                      # hd not a multiple of 8
        flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                        k[..., :12].contiguous())
    with pytest.raises(ValueError):                      # strided q
        flash_attention(q[:, ::2], k, k)
    assert flash_attention.launches == n0 + 1


def test_reduced_serve_loop_on_card_matches_cpu(cuda):
    """Reduced qwen2-1.5b (f32) with B3: the card's ServeLoop gives the
    CPU's tokens on the same weights and requests."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              flash_attention=True)
    cpu_model = build_model(cfg).init(torch.Generator().manual_seed(21))
    loops = [ServeLoop(cfg, cpu_model, max_batch=2, max_len=128, device="cpu"),
             ServeLoop(cfg, copy.deepcopy(cpu_model).to(cuda), max_batch=2,
                       max_len=128, device=cuda)]
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 90, 65)]
    outs = []
    n0 = flash_attention.launches
    for sl in loops:
        reqs = [sl.submit(p, max_new=6) for p in prompts]
        sl.run_until_idle()
        outs.append([r.output for r in reqs])
    assert flash_attention.launches == n0 + 2 * cfg.num_layers
    assert outs[1] == outs[0]


def _ssd_inputs(b, s, h, p, n, dtype, cuda, seed, a_scale=1.0):
    x = _randn(b, s, h, p, seed=seed).to(cuda, dtype)
    a = -a_scale * torch.nn.functional.softplus(_randn(b, s, h, seed=seed + 1))
    a = a.to(cuda)
    B = _randn(b, s, n, seed=seed + 2).to(cuda, dtype)
    C = _randn(b, s, n, seed=seed + 3).to(cuda, dtype)
    return x, a, B, C


# (s, chunk, h, p, n, a_scale): tests/test_kernels.py's shapes, then ragged
# ones (s off the chunk for chunk 16, 32 and 64), n = 64 and 24 (off the
# tensor cores' 16), p = 8 and 48 (off the kernel's 32-row p-slice), 64
# chunks (the state carried far), a near 0 (decay about 1: the state
# grows, and its f32 tolerance is the tightest), and chunks of 48 and 24,
# not multiples of the bf16 kernel's 16-step tiles
SSD_SHAPES = [(64, 16, 2, 8, 4, 1.0), (128, 64, 4, 64, 16, 1.0),
              (96, 32, 1, 16, 8, 1.0), (1000, 64, 2, 16, 8, 1.0),
              (77, 16, 3, 64, 128, 1.0), (100, 32, 2, 64, 64, 1.0),
              (130, 64, 2, 8, 24, 1.0), (70, 64, 2, 48, 32, 1.0),
              (4096, 64, 1, 64, 128, 1.0), (1000, 64, 2, 64, 128, 1e-4),
              (100, 48, 2, 64, 128, 1.0), (50, 24, 2, 8, 24, 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,h,p,n,a_scale", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, dtype, s, chunk, h, p, n, a_scale):
    """f32: tests/test_kernels.py's 2e-4 (sums in another order).  bf16: both
    round the f32 value of y once, so one bf16 step (up to 2^-7 of |y|)
    where the sums fall on two sides of a rounding boundary, and h_prev,
    rounded to bf16 by both, can do the same (2^-8 of its product with C);
    both are bounded by 1.2e-2 of the sum of the terms' magnitudes, which
    the plain version computes on |x|, |B|, |C|."""
    x, a, B, C = _ssd_inputs(2, s, h, p, n, dtype, cuda, seed=30,
                             a_scale=a_scale)
    y, st = ssd_scan(x, a, B, C, chunk)
    ye, ste = ssd_scan_plain(x, a, B, C, chunk)
    assert y.dtype == dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (2, h, p, n)
    torch.testing.assert_close(st, ste, atol=2e-4, rtol=2e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ye, atol=2e-4, rtol=2e-4)
    else:
        scale = ssd_scan_plain(x.float().abs(), a, B.float().abs(),
                               C.float().abs(), chunk)[0]
        assert ((y.float() - ye.float()).abs() <= 1.2e-2 * scale).all()


def test_ssd_wrapper_counts_launches_and_rejects_what_it_cannot_take(cuda):
    x, a, B, C = _ssd_inputs(1, 40, 2, 8, 4, torch.float32, cuda, seed=40)
    n0 = ssd_scan.launches
    ssd_scan(x, a, B, C, 16)
    assert ssd_scan.launches == n0 + 1
    with pytest.raises(ValueError):                      # strided x
        ssd_scan(x[:, :, :, ::2], a, B, C, 16)
    with pytest.raises(ValueError):                      # strided B
        ssd_scan(x, a, torch.cat([B, B], -1)[..., ::2], C, 16)
    with pytest.raises(TypeError):                       # B in another dtype
        ssd_scan(x, a, B.bfloat16(), C, 16)
    with pytest.raises(TypeError):                       # a not f32
        ssd_scan(x, a.double(), B, C, 16)
    with pytest.raises(ValueError):                      # chunk above 64
        ssd_scan(x, a, B, C, 128)
    assert ssd_scan.launches == n0 + 1


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_reduced_ssm_serve_loop_on_card_matches_cpu(cuda, arch):
    """Reduced mamba2-370m and zamba2-7b (f32) with B4 (and B3 for zamba2's
    shared attention): the card's ServeLoop gives the CPU's tokens on the
    same weights and requests."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              flash_attention=True)
    cpu_model = build_model(cfg).init(torch.Generator().manual_seed(23))
    loops = [ServeLoop(cfg, cpu_model, max_batch=2, max_len=128, device="cpu"),
             ServeLoop(cfg, copy.deepcopy(cpu_model).to(cuda), max_batch=2,
                       max_len=128, device=cuda)]
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 90, 65)]
    outs = []
    n0, f0 = ssd_scan.launches, flash_attention.launches
    for sl in loops:
        reqs = [sl.submit(p, max_new=6) for p in prompts]
        sl.run_until_idle()
        outs.append([r.output for r in reqs])
    groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert ssd_scan.launches == n0 + 2 * cfg.num_layers
    assert flash_attention.launches == f0 + 2 * groups
    assert outs[1] == outs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_gradients_on_card_match_plain(cuda, dtype, use_state):
    """B4 under autograd (the kernel's forward; the plain backward, its
    recurrence over chunks the two state-pass launches) against autograd
    through the plain version on the card, which launches nothing: y within
    the kernel's tolerance, the gradients equal within 1e-6 of the largest
    (the same backward but for the order of the decays' gradient sums), one
    B4 launch and two state-pass launches."""
    base = _ssd_inputs(2, 300, 4, 64, 128, dtype, cuda, seed=50)
    dy = _randn(2, 300, 4, 64, seed=54).to(cuda, dtype)
    dst = _randn(2, 4, 64, 128, seed=55).to(cuda)

    def run(fn):
        ins = [t.detach().clone().requires_grad_() for t in base]
        y, st = fn(*ins, 64)
        loss = (y.float() * dy.float()).sum()
        if use_state:
            loss = loss + (st * dst).sum()
        loss.backward()
        return y.detach(), [t.grad.float() for t in ins]

    n0, m0 = ssd_scan.launches, ssd_state_pass.launches
    y, grads = run(ssd_scan)
    assert (ssd_scan.launches, ssd_state_pass.launches) == (n0 + 1, m0 + 2)
    ye, grads_e = run(ssd_scan_plain)
    assert (ssd_scan.launches, ssd_state_pass.launches) == (n0 + 1, m0 + 2)
    x, a, B, C = base
    scale = ssd_scan_plain(x.float().abs(), a, B.float().abs(),
                           C.float().abs(), 64)[0]
    tol = 2e-4 if dtype == torch.float32 else 1.2e-2
    assert ((y.float() - ye.float()).abs() <= tol * scale + 1e-6).all()
    for a, b in zip(grads, grads_e):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


# (b, c, h, p, n): one chunk, an odd count, p * n = 15 (no multiple of the
# kernels' four-float vectors), 1,152 (no multiple of a block's 1,024),
# 16,384 (two rounds of an 8-block cluster), 70 chunks (tiles of 32 and a
# ragged last one), and granite's 128 chunks at a few heads
STATE_PASS_SHAPES = [(2, 1, 3, 64, 128), (2, 7, 3, 64, 128),
                     (2, 9, 3, 3, 5), (1, 33, 2, 48, 24),
                     (1, 5, 2, 64, 256), (2, 70, 2, 16, 8),
                     (2, 128, 4, 64, 128)]


def _state_pass_grads(fn, states, decay, gp, gl):
    s = states.clone().requires_grad_()
    d = decay.clone().requires_grad_()
    hprev, hlast = fn(s, d)
    terms = []
    if gp is not None:
        terms.append((hprev * gp).sum())
    if gl is not None:
        terms.append((hlast * gl).sum())
    sum(terms).backward()
    return hprev.detach(), hlast.detach(), s.grad, d.grad


# with one chunk hprev is the zero state: only hlast's gradient reaches the
# inputs
@pytest.mark.parametrize("b,c,h,p,n,grads", [
    (*shape, grads) for shape in STATE_PASS_SHAPES
    for grads in ("both", "hprev", "hlast")
    if shape[1] > 1 or grads != "hprev"])
def test_state_pass_kernels_match_plain(cuda, b, c, h, p, n, grads):
    """The state-pass launches against ``ssd_state_pass_plain`` on the same
    inputs on the card: ``hprev``, ``hlast`` and the states' gradient bit
    for bit (each product and sum rounded as the plain loop rounds it), the
    decays' within 1e-6 of its largest magnitude (a sum over p * n in
    another order) and the same in two runs; two launches a forward and
    backward."""
    states = _randn(b, c, h, p, n, seed=60).to(cuda)
    # decays in (0.5, 1]: the state neither dies nor grows far over c chunks
    decay = (1 - 0.5 * torch.rand(b, c, h, generator=torch.Generator()
                                  .manual_seed(61))).to(cuda)
    gp = _randn(b, c, h, p, n, seed=62).to(cuda) if grads != "hlast" else None
    gl = _randn(b, h, p, n, seed=63).to(cuda) if grads != "hprev" else None
    n0 = ssd_state_pass.launches
    got = _state_pass_grads(ssd_state_pass, states, decay, gp, gl)
    assert ssd_state_pass.launches == n0 + 2
    again = _state_pass_grads(ssd_state_pass, states, decay, gp, gl)
    want = _state_pass_grads(ssd_state_pass_plain, states, decay, gp, gl)
    assert ssd_state_pass.launches == n0 + 4
    for name, a, e in zip(("hprev", "hlast", "dstates"), got, want):
        assert torch.equal(a, e), name
    dd, dd_e = got[3], want[3]
    assert torch.equal(dd, again[3])
    assert (dd - dd_e).abs().max() <= 1e-6 * dd_e.abs().max()
# -- the rest of the model zoo: reduced models on the card against the CPU ---------------
def _reduced_pair(arch, seed, **kw):
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    cpu = build_model(cfg).init(torch.Generator().manual_seed(seed))
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


def test_reduced_granite_serve_loop_on_card_matches_cpu(cuda):
    """Reduced granite-moe-3b-a800m (f32) with B3: the card's ServeLoop gives
    the CPU's tokens (decode steps route each batch as one MoE group)."""
    cfg, cpu, card = _reduced_pair("granite-moe-3b-a800m", 56,
                                   flash_attention=True)
    rng = np.random.default_rng(57)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 90, 65)]
    outs = []
    n0 = flash_attention.launches
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        sl = ServeLoop(cfg, model, max_batch=2, max_len=128, device=dev)
        reqs = [sl.submit(p, max_new=6) for p in prompts]
        sl.run_until_idle()
        outs.append([r.output for r in reqs])
    assert flash_attention.launches == n0 + 2 * cfg.num_layers
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-tiny",
                                  "internvl2-26b", "mamba2-370m", "zamba2-7b"])
def test_reduced_loss_and_gradients_on_card_match_cpu(cuda, arch):
    """f32, B3 and B4 on: the loss within 1e-5 relative and every gradient
    within 1e-4 of the largest of the CPU's, from the same weights and
    batch (frames or image features included)."""
    from repro_torch.launch.inputs import train_batch
    cfg, cpu, card = _reduced_pair(arch, 58, flash_attention=True)
    batch = train_batch(cfg, 2, 64, rng=np.random.default_rng(59),
                        device="cpu")
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        model.requires_grad_(True)
        loss = model.loss({k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    got = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        g = got[name].grad.cpu()
        assert (g - p.grad).abs().max() <= 1e-4 * p.grad.abs().max(), name


def test_reduced_whisper_and_internvl_steps_on_card_match_cpu(cuda):
    """Whisper's audio prefill step and eight decode steps, InternVL's vlm
    prefill step (B3 in every layer) and six decode steps: the card's logits
    within 1e-4 of the CPU's."""
    from repro_torch.launch.inputs import train_batch
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    for arch in ("whisper-tiny", "internvl2-26b"):
        cfg, cpu, card = _reduced_pair(arch, 60, flash_attention=True)
        batch = train_batch(cfg, 2, 24, rng=np.random.default_rng(61),
                            device="cpu")
        runs = []
        f0 = flash_attention.launches
        for model, dev in ((cpu, "cpu"), (card, cuda)):
            b = {k: v.to(dev) for k, v in batch.items()}
            pre = make_prefill_step(model, cfg, 64)
            dec = make_decode_step(model, cfg)
            with torch.inference_mode():
                if cfg.family == "audio":
                    logs = [pre(b)]
                    enc = model.encode(b["frames"])
                    cache = model.init_cache(2, 16, dev)
                    for t in range(8):
                        out, cache = dec(cache, b["tokens"][:, t:t + 1], enc)
                        logs.append(out)
                else:
                    out, cache = pre(b)
                    logs = [out]
                    for _ in range(6):
                        out, cache = dec(cache, logs[0].argmax(-1)[:, None])
                        logs.append(out)
            runs.append([x.cpu() for x in logs])
        want = cfg.num_layers if cfg.family == "vlm" else 0
        assert flash_attention.launches == f0 + want
        for a, b in zip(*runs):
            assert (a - b).abs().max() <= 1e-4, arch


# -- reductions, budgets and lookahead on the card -----------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64,
                                   torch.bfloat16])
def test_reduction_contributions_from_card_tensors(cuda, dtype):
    """Kernels contribute tensors on the card in four dtypes; the exact sum
    and the max equal those of the same values on the host (bf16 widens to
    f32 exactly, int64 stays exact above 2^53)."""
    n = 1000
    rng = np.random.default_rng(30)
    if dtype == torch.int64:
        data = rng.integers(-2 ** 40, 2 ** 40, size=n) + 2 ** 53
        buf_dtype = np.int64
    else:
        data = rng.normal(size=n) * 10.0 ** rng.integers(-20, 20, size=n)
        buf_dtype = np.float64
    with Runtime(2, 2) as rt:
        X = rt.buffer((n,), dtype=buf_dtype, init=data, name="X")
        S = rt.buffer((1,), dtype=buf_dtype, init=np.zeros(1, buf_dtype),
                      name="S")
        M = rt.buffer((1,), dtype=buf_dtype, init=np.zeros(1, buf_dtype),
                      name="M")

        def k(chunk, xv, sum_red, max_red):
            x = xv.get(chunk)
            assert x.is_cuda
            sum_red.contribute(x.to(dtype))
            max_red.contribute(x.to(dtype))

        rt.submit("k", (n,), [read(X, one_to_one()), reduction(S, "sum"),
                              reduction(M, "max")], k)
        got_sum, got_max = rt.gather(S)[0], rt.gather(M)[0]
    host = torch.from_numpy(data).to(dtype)
    if dtype == torch.int64:
        assert int(got_sum) == int(data.sum()) and int(got_max) == data.max()
    else:
        vals = host.double().numpy()
        assert got_sum == math.fsum(vals) and got_max == vals.max()


def test_include_current_value_on_device_buffer(cuda):
    """E is read on the card before and after a reduction that folds its
    current value in: the card sees the old value, then the new one."""
    data = np.arange(32.0)
    with Runtime(2, 2) as rt:
        X = rt.buffer((32,), init=data, name="X")
        E = rt.buffer((1,), init=np.full(1, 5.5), name="E")
        O = [rt.buffer((4,), init=np.zeros(4), name=f"O{i}") for i in (1, 2)]

        def use(chunk, ev, ov):
            ov.set(chunk, ov.get(chunk) + ev.get(Box((0,), (1,)))[0])

        def k(chunk, xv, red):
            red.contribute(xv.get(chunk))

        rt.submit("use1", (4,), [read(E, all_range()),
                                 read_write(O[0], one_to_one())], use)
        rt.submit("k", (32,), [read(X, one_to_one()),
                               reduction(E, "sum", include_current_value=True)],
                  k)
        rt.submit("use2", (4,), [read(E, all_range()),
                                 read_write(O[1], one_to_one())], use)
        o1, o2 = rt.gather(O[0]), rt.gather(O[1])
    assert list(o1) == [5.5] * 4
    assert list(o2) == [math.fsum(list(data) + [5.5])] * 4


def test_body_energies_rows_equal_full_range_on_card(cuda):
    """A row's energy has the same bits in any row range (the sum order is
    fixed by N), and the same bits as the CPU's, which follow numpy's."""
    N = 5000
    P = _randn(N, 3, seed=31).to(cuda)
    V = _randn(N, 3, seed=32).to(cuda) * 0.1
    full = body_energies(P, V, 0, N, 1e-3)
    assert torch.equal(full.cpu(), body_energies(P.cpu(), V.cpu(), 0, N,
                                                 1e-3))
    for lo, hi in _splits(N, seed=33):
        assert torch.equal(body_energies(P, V[lo:hi], lo, hi, 1e-3),
                           full[lo:hi]), (lo, hi)


def test_energy_program_bit_identical_across_grids_on_card(cuda):
    rng = np.random.default_rng(34)
    P0 = rng.standard_normal((2048, 3), dtype=np.float32)
    V0 = rng.standard_normal((2048, 3), dtype=np.float32) * 0.1
    runs = []
    for nodes, devices in ((1, 1), (2, 2), (3, 1)):
        with Runtime(nodes, devices) as rt:
            sim = NBody(rt, P0, V0, 1e-3, 1e-3)
            sim.advance(4, energy_every=4)
            runs.append((sim.energy(), sim.gather(), sim.gather_velocities()))
    for energy, P, V in runs[1:]:
        assert energy == runs[0][0]
        np.testing.assert_array_equal(P, runs[0][1])
    _, P, V = runs[0]
    e = body_energies(torch.from_numpy(P), torch.from_numpy(V), 0, 2048, 1e-3)
    assert runs[0][0] == (math.fsum(e.numpy()),
                          math.fsum((1e-3 * torch.from_numpy(V)[:, 0]).numpy()))


def test_spill_and_reload_bitwise_on_card(cuda):
    """tests/test_memory.py's phased program on the card at 50% of its
    device high-water mark: spills into pinned host memory and reloads,
    results bitwise equal, the runtime's device peak under the budget."""
    n = 1 << 16

    def program(rt):
        rng = np.random.default_rng(35)
        bufs = [(rt.buffer((n,), init=rng.normal(size=n), name=f"A{g}"),
                 rt.buffer((n,), init=np.zeros(n), name=f"B{g}"))
                for g in range(3)]

        def steps(g, lo, hi):
            A, B = bufs[g]
            for s in range(lo, hi):
                def k(chunk, av, bv, s=s):
                    bv.set(chunk, bv.get(chunk) + av.get(chunk) * (s + 1))
                rt.submit(f"g{g}s{s}", (n,), [read(A, one_to_one()),
                                              read_write(B, one_to_one())], k)

        steps(0, 0, 3)
        for g in (1, 2):
            steps(g, 0, 6)
        steps(0, 3, 6)
        return [rt.gather(B) for _, B in bufs]

    with Runtime(2, 2) as rt:
        base = program(rt)
        hwm = rt.device_peak_bytes()
    with Runtime(2, 2, device_memory_budget=hwm // 2) as rt:
        out = program(rt)
        reports = rt.memory_report()
        peak = rt.device_peak_bytes()
        assert rt.warnings == []
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a, b)
    assert peak <= hwm // 2
    assert sum(r["spills"] for r in reports) > 0
    assert sum(r["reloads"] for r in reports) > 0
    assert reports[0]["cuda_max_allocated"] >= reports[0]["cuda_allocated"] > 0


def test_wave_residual_equals_fsum_on_card(cuda):
    rng = np.random.default_rng(36)
    u0 = rng.standard_normal((300, 200), dtype=np.float32)
    u1 = rng.standard_normal((300, 200), dtype=np.float32)
    with Runtime(2, 2) as rt:
        sim = WaveSim(rt, u0, u1)
        sim.advance(7)
        sim.residual()
        field, prev, res2 = (sim.gather(), sim.gather_previous(),
                             sim.residual_value())
    assert res2 == math.fsum(((field - prev) ** 2).ravel())


def test_wave_steps_write_in_place_on_card(cuda):
    """A 1 x 1 WaveSim of 4096^2 float32: after a warm-up step, ten steps
    allocate no more than 1 MiB beyond the three fields (B2 writes into the
    new field's allocation, no temporary), copy nothing from device to
    device, and give the field of the runtime-free steps (bit for bit) and
    of ``wave_step_rows_plain``'s (to B2's one-step tolerance)."""
    H = W = 4096
    steps = 10
    rng = np.random.default_rng(41)
    u0 = rng.standard_normal((H, W), dtype=np.float32)
    u1 = rng.standard_normal((H, W), dtype=np.float32)
    fields = 3 * u0.nbytes
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with Runtime(1, 1) as rt:
        sim = WaveSim(rt, u0, u1)
        sim.advance(1)
        rt.sync()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - base >= fields
        torch.cuda.reset_peak_memory_stats()
        n0, i0 = wave_step_rows.launches, wave_step_rows.in_place
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            sim.advance(steps)
            rt.sync()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert wave_step_rows.launches - n0 == steps
        assert wave_step_rows.in_place - i0 == steps
        field = sim.gather()
    assert peak <= fields + 2**20, (peak, fields)
    names = [e.name for e in prof.events()]
    assert any("wave_rows_kernel" in n for n in names), sorted(set(names))
    assert not any("Memcpy DtoD" in n for n in names), sorted(set(names))
    um, u = torch.from_numpy(u0).to(cuda), torch.from_numpy(u1).to(cuda)
    pm, p = um, u
    for _ in range(steps + 1):
        um, u = u, wave_step_rows(um, u, 0, H)
        pm, p = p, wave_step_rows_plain(pm, p, 0, H)
    np.testing.assert_array_equal(field, u.cpu().numpy())
    torch.testing.assert_close(torch.from_numpy(field), p.cpu(),
                               rtol=1e-5, atol=1e-5)


def test_rsim_allocations_on_card_equal_cpu(cuda):
    runs = {(d, la): run_rsim(32, 8192, lookahead=la, dtype=np.float32,
                              device=d)
            for d in ("cuda", "cpu") for la in (True, False)}
    for la in (True, False):
        assert runs[("cuda", la)][1] == runs[("cpu", la)][1]
        np.testing.assert_allclose(runs[("cuda", la)][0],
                                   runs[("cpu", la)][0], rtol=1e-5)
    assert runs[("cuda", True)][1] < runs[("cuda", False)][1]


def test_renamed_allocations_are_cuda_tensors(cuda):
    """Fault C2 on the card: under renaming every buffer allocation a kernel
    sees is a CUDA tensor, and the bytes equal the renaming-off run's."""
    n = 1 << 16
    a0 = np.random.default_rng(37).standard_normal(n, dtype=np.float32)

    def program(rt, seen):
        A = rt.buffer((n,), dtype=np.float32, init=a0, name="A")
        B = rt.buffer((n,), dtype=np.float32, init=np.zeros_like(a0),
                      name="B")
        for s in range(6):
            def k(chunk, av, bv, _s=s):
                seen.update((type(av.array), av.array.device.type,
                             bv.array.device.type))
                bv.set(chunk, av.get(chunk) * (_s + 2))
            rt.submit(f"s{s}", (n,), [read(A, one_to_one()),
                                      write(B, one_to_one())], k)
        return rt.gather(B)

    runs = {}
    for ren in (False, True):
        seen = set()
        with Runtime(2, 2, renaming=ren) as rt:
            runs[ren] = program(rt, seen)
            renames = sum(r["renames"] for r in rt.memory_report())
        assert seen == {torch.Tensor, "cuda"}, seen
    np.testing.assert_array_equal(runs[True], runs[False])
    assert renames > 0


def test_replayed_windows_bitwise_equal_cold_on_card(cuda):
    """Both simulations served as tenants: with memo on most windows are
    replays, and every result is bitwise that of memo off (all windows
    lowered cold) and of the runtime-free steps; B1 and B2 ran in every
    window."""
    rng = np.random.default_rng(38)
    u0 = rng.standard_normal((512, 256), dtype=np.float32)
    u1 = rng.standard_normal((512, 256), dtype=np.float32)
    P0 = rng.standard_normal((1024, 3), dtype=np.float32)
    V0 = rng.standard_normal((1024, 3), dtype=np.float32) * 0.1
    dt, mass = 1e-3, 1.0 / 1024
    out = {}
    for memo in (True, False):
        nbody_forces_rows.launches = wave_step_rows.launches = 0
        with ServingRuntime(2, 2, memo=memo) as srv:
            r = serve_simulations(srv, u0, u1, P0, V0, wave_windows=12,
                                  nbody_windows=6, dt=dt, mass=mass)
            tenants = srv.memo_stats()["tenants"]
        assert wave_step_rows.launches == 12 * 4
        assert nbody_forces_rows.launches == 6 * 4
        out[memo] = (r["wave"]["field"], r["nbody"]["P"], tenants)
    assert out[True][2]["wave"]["replayed"] > 0
    assert out[True][2]["nbody"]["replayed"] > 0
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    um, u = torch.from_numpy(u0).to(cuda), torch.from_numpy(u1).to(cuda)
    for _ in range(12):
        um, u = u, wave_step_rows(um, u, 0, 512, 0.25)
    np.testing.assert_array_equal(out[True][0], u.cpu().numpy())


@pytest.mark.parametrize("renaming", [False, True], ids=["plain", "renaming"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_no_wait_pipelined_tenants_bitwise_on_card(cuda, depth, renaming):
    """Fault C6 on the card, where each lane is a CUDA stream: WaveSim and
    N-body clients that submit every window and drain once, memo on, with
    ``depth`` windows in flight.  Each of three runs gives the bytes of
    memo off and of the runtime-free steps, and B1 and B2 ran in every
    window."""
    rng = np.random.default_rng(0)
    P0 = rng.standard_normal((1024, 3), dtype=np.float32)
    V0 = rng.standard_normal((1024, 3), dtype=np.float32) * 0.1
    u0 = rng.standard_normal((512, 256), dtype=np.float32)
    u1 = rng.standard_normal((512, 256), dtype=np.float32)
    dt, mass = 1e-3, 1.0 / 1024

    def run(memo):
        nbody_forces_rows.launches = wave_step_rows.launches = 0
        with ServingRuntime(2, 2, memo=memo, renaming=renaming,
                            max_inflight_windows=depth) as srv:
            r = serve_simulations(srv, u0, u1, P0, V0, wave_windows=40,
                                  nbody_windows=10, dt=dt, mass=mass,
                                  wait=False)
            replayed = srv.tenants["nbody"].replayed_windows
        assert wave_step_rows.launches == 40 * 4
        assert nbody_forces_rows.launches == 10 * 4
        return r["wave"]["field"], r["nbody"]["P"], replayed

    off_field, off_P, _ = run(False)
    um, u = torch.from_numpy(u0).to(cuda), torch.from_numpy(u1).to(cuda)
    for _ in range(40):
        um, u = u, wave_step_rows(um, u, 0, 512, 0.25)
    P, V = torch.from_numpy(P0).to(cuda), torch.from_numpy(V0).to(cuda)
    for _ in range(10):
        V = V + mass * nbody_forces_rows(P, 0, 1024) * dt
        P = P + V * dt
    np.testing.assert_array_equal(off_field, u.cpu().numpy())
    np.testing.assert_array_equal(off_P, P.cpu().numpy())
    for rep in range(3):
        field, pos, replayed = run(True)
        assert replayed > 0
        np.testing.assert_array_equal(field, off_field, err_msg=f"run {rep}")
        np.testing.assert_array_equal(pos, off_P, err_msg=f"run {rep}")


def test_crash_teardown_returns_device_memory(cuda):
    """A fail-stopped WaveSim run on 2 x 2: after ``shutdown``, with the
    garbage collector off, PyTorch holds the device memory it held before
    the run."""
    rng = np.random.default_rng(39)
    u0 = rng.standard_normal((1024, 512), dtype=np.float32)
    u1 = rng.standard_normal((1024, 512), dtype=np.float32)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        rt = Runtime(2, 2, fault_plan=FaultPlan(crash={1: 40}),
                     watchdog_timeout=0.3)
        try:
            WaveSim(rt, u0, u1).advance(10)
            with pytest.raises(ExecutionAborted, match="N1"):
                rt.sync(timeout=30.0)
            assert torch.cuda.memory_allocated() > before
        finally:
            rt.shutdown()
        assert rt.thread_report()["total_leaked"] == 0
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == before
    finally:
        gc.enable()


# -- the core parity twins on the card's streams, and fault C5 ----------------
class _RecordingTracer:
    """Tracer double: (event, name) in order, as in
    ``tests/test_torch_executor_ready.py``."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def issue(self, node, instr):
        with self._lock:
            self.events.append(("issue", instr.name))

    def record(self, node, instr, lane, **stamps):
        with self._lock:
            self.events.append(("complete", instr.name))

    def counter(self, name, value):
        pass

    def wait_for(self, event, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if event in self.events:
                    return True
            time.sleep(0.001)
        return False

    def snapshot(self):
        with self._lock:
            return list(self.events)


def test_eager_issue_on_one_stream_on_card(cuda):
    """A device instruction whose unfinished dependency sits on one card
    stream is issued before that dependency completes, onto the same
    stream, and completes after it (§4.1)."""
    from repro_torch.core.communicator import Communicator
    from repro_torch.core.executor import Executor
    from repro_torch.core.instruction_graph import (Instruction,
                                                    InstructionType)
    from repro_torch.core.task_graph import DepKind

    def kernel(name, fn, deps=()):
        i = Instruction(InstructionType.DEVICE_KERNEL, node=0,
                        queue=("device", 0), kernel_fn=fn, name=name,
                        device=0)
        for d in deps:
            i.add_dependency(d, DepKind.TRUE)
        return i

    tracer = _RecordingTracer()
    ex = Executor(0, 1, Communicator(1), device=cuda, queues_per_device=2,
                  host_threads=1, tracer=tracer)
    gate = threading.Event()
    try:
        a = kernel("A", lambda chunk: gate.wait(5))
        b = kernel("B", lambda chunk: torch.cuda._sleep(1000), deps=[a])
        ex.submit([a, b])
        assert tracer.wait_for(("issue", "A"))
        assert tracer.wait_for(("issue", "B"))
        assert ("complete", "A") not in tracer.snapshot()
        qa, qb = ex._issued_on.get(a.iid), ex._issued_on.get(b.iid)
        assert qa is not None and qa is qb
        gate.set()
        assert tracer.wait_for(("complete", "B"))
        ev = tracer.snapshot()
        assert ev.index(("complete", "A")) < ev.index(("complete", "B"))
    finally:
        gate.set()
        ex.shutdown()


def test_scheduler_overlaps_execution_on_card(cuda):
    """30 kernels on 1 x 2 cards' streams, traced: the scheduler's and the
    device lanes' spans are recorded, their overlap is computable, and the
    result is the 30 increments."""
    with Runtime(1, 2, trace=True, device="cuda") as rt:
        X = rt.buffer((64,), init=np.zeros(64), name="X")

        def slow(chunk, xv):
            torch.cuda._sleep(2_000_000)
            xv.set(chunk, xv.get(chunk) + 1)

        for i in range(30):
            rt.submit(f"k{i}", (64,), [read_write(X, one_to_one())], slow)
        rt.sync()
        out = rt.gather(X)
        tr = rt.tracer
    lanes = tr.lanes()
    assert any(n.startswith("sched-") for n in lanes)
    assert any(".device" in n for n in lanes), lanes.keys()
    assert tr.overlap_fraction("sched-N0", "N0.device") >= 0.0
    np.testing.assert_array_equal(out, np.full(64, 30.0))


def _exchange_on_card(mapper, cap):
    """``tests/test_torch_memo.py``'s exchanging program (fault C5) on a
    ``ServingRuntime(2, 1)`` on the card: A and the in-flight counts."""
    n = 64
    with ServingRuntime(2, 1, max_inflight_per_tenant=cap) as srv:
        t = srv.tenant("t0")
        a = t.buffer((n,), init=np.arange(n, dtype=np.float64), name="A")
        b = t.buffer((n,), init=np.zeros(n), name="B")
        for src, dst in ((a, b), (b, a)):
            t.submit(f"{dst.name} <- {src.name} + 1", (n,),
                     [read(src, mapper), write(dst, one_to_one())],
                     lambda c, s, d: d.set(c, s.get(c) + 1.0))
            t.run()
        out = t.gather(a)
        t.drain()
        inflight = [dict(ex._tenant_inflight) for ex in srv.executors]
    return out, inflight


@pytest.mark.parametrize("reads", ["neighborhood", "all_range"])
def test_admission_cap_of_one_on_exchanging_windows_on_card(cuda, reads):
    """Fault C5 on the card: the capped run finishes within 30 s with the
    bytes of the uncapped one, and its in-flight counts drain."""
    mapper = neighborhood((1,)) if reads == "neighborhood" else all_range()
    result = {}

    def capped():
        try:
            result["out"] = _exchange_on_card(mapper, 1)
        except BaseException as e:
            result["error"] = e

    th = threading.Thread(target=capped, daemon=True)
    th.start()
    th.join(30.0)
    assert not th.is_alive(), "cap 1 did not finish within 30 s (fault C5)"
    if "error" in result:
        raise result["error"]
    got, inflight = result["out"]
    want, _ = _exchange_on_card(mapper, None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, np.arange(64) + 2.0)
    assert all(v == 0 for counts in inflight for v in counts.values())


# -- the kernels as custom ops, and the dry-run over fake CUDA tensors --------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_lse", [False, True])
def test_flash_custom_op_matches_plain(cuda, dtype, want_lse):
    """``repro_torch::flash_attention_fwd`` called as an op launches B3 once,
    within FLASH_TOL of the plain version (lse within 1e-4), with the
    shapes of its fake implementation."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q = _randn(2, 200, 2, 6, 128, seed=50).to(cuda, dtype)
    k = _randn(2, 200, 2, 128, seed=51).to(cuda, dtype)
    v = _randn(2, 200, 2, 128, seed=52).to(cuda, dtype)
    n0 = flash_attention.launches
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 32, 0,
                                                         want_lse)
    assert flash_attention.launches == n0 + 1
    exp, exp_lse = flash_attention_plain(q, k, v, causal=True, window=32,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), exp.float(), **FLASH_TOL[dtype])
    if want_lse:
        torch.testing.assert_close(lse, exp_lse, atol=1e-4, rtol=1e-4)
    else:
        assert lse.numel() == 0
    with FakeTensorMode() as mode:
        fo, fl = torch.ops.repro_torch.flash_attention_fwd(
            *(mode.from_tensor(t) for t in (q, k, v)), True, 32, 0, want_lse)
    assert flash_attention.launches == n0 + 1
    assert (fo.shape, fo.dtype, fl.shape) == (out.shape, out.dtype, lse.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_custom_op_matches_plain(cuda, dtype):
    """``repro_torch::ssd_scan_fwd`` called as an op launches B4 once, within
    the tolerances of ``test_ssd_kernel_matches_plain``."""
    x, a, B, C = _ssd_inputs(2, 256, 4, 64, 128, dtype, cuda, seed=53)
    n0 = ssd_scan.launches
    y, st = torch.ops.repro_torch.ssd_scan_fwd(x, a, B, C, 64)
    assert ssd_scan.launches == n0 + 1
    ye, ste = ssd_scan_plain(x, a, B, C, 64)
    torch.testing.assert_close(st, ste, atol=2e-4, rtol=2e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ye, atol=2e-4, rtol=2e-4)
    else:
        scale = ssd_scan_plain(x.float().abs(), a, B.float().abs(),
                               C.float().abs(), 64)[0]
        assert ((y.float() - ye.float()).abs() <= 1.2e-2 * scale).all()


def test_direct_launches_equal_custom_op_launches(cuda):
    """Plain CUDA tensors launch B3 and B4 directly, bit for bit what the
    custom ops give, one launch each; under ``FlopCounterMode`` the same
    calls go through the ops and are counted."""
    from torch.utils.flop_counter import FlopCounterMode
    q = _randn(2, 200, 2, 6, 128, seed=54).to(cuda, torch.bfloat16)
    k = _randn(2, 200, 2, 128, seed=55).to(cuda, torch.bfloat16)
    v = _randn(2, 200, 2, 128, seed=56).to(cuda, torch.bfloat16)
    x, a, B, C = _ssd_inputs(2, 256, 4, 64, 128, torch.bfloat16, cuda,
                             seed=57)
    n0, m0 = flash_attention.launches, ssd_scan.launches
    out = flash_attention(q, k, v)
    y, st = ssd_scan(x, a, B, C, 64)
    assert (flash_attention.launches, ssd_scan.launches) == (n0 + 1, m0 + 1)
    assert torch.equal(out, torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, True, 0, 0, False)[0])
    yo, sto = torch.ops.repro_torch.ssd_scan_fwd(x, a, B, C, 64)
    assert torch.equal(y, yo) and torch.equal(st, sto)
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v)
        ssd_scan(x, a, B, C, 64)
    assert (flash_attention.launches, ssd_scan.launches) == (n0 + 3, m0 + 3)
    counts = {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}
    assert counts.get("repro_torch.flash_attention_fwd", 0) > 0, counts
    assert counts.get("repro_torch.ssd_scan_fwd", 0) > 0, counts


@pytest.mark.parametrize("arch,kind", [("qwen2_1_5b", "train"),
                                       ("qwen2_1_5b", "prefill"),
                                       ("mamba2_370m", "train"),
                                       ("granite_moe_1b_a400m", "train")])
def test_dryrun_traces_kernels_without_launching(cuda, arch, kind):
    """A dry-run over fake CUDA tensors (flash attention on) reaches B3's and
    B4's custom ops through their sharding rules on a fake (2, 2) mesh and
    launches neither; at (1, 1) its FLOPs equal a ``FlopCounterMode`` count
    of the same step run for real."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.launch.inputs import train_batch
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              flash_attention=True, dtype="bfloat16")
    spec = dict(seq_len=128, global_batch=4, kind=kind)
    n0 = (flash_attention.launches + ssd_scan.launches
          + ssd_state_pass.launches)
    try:
        rec = lower_cell(arch, kind, cfg=cfg, device="cuda", spec=spec,
                         mesh=make_dev_mesh(2, 2, device="cuda"))
        assert rec["flops"] > 0 and rec["chips"] == 4
        one = lower_cell(arch, kind, cfg=cfg, device="cuda", spec=spec,
                         mesh=make_dev_mesh(1, 1, device="cuda"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert (flash_attention.launches + ssd_scan.launches
            + ssd_state_pass.launches) == n0
    model = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0))
    batch = train_batch(cfg, 4, 128, device=cuda)
    if kind == "train":
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        step, opt = make_train_step(model), adamw_init(params)
        with FlopCounterMode(display=False) as fc:
            step(params, opt, batch)
    else:
        batch.pop("labels")
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            make_prefill_step(model, cfg, 128)(batch)
    assert (flash_attention.launches + ssd_scan.launches
            + ssd_state_pass.launches) > n0
    assert one["flops"] == fc.get_total_flops()


# -- granite-4.0-h (hybrid_moe): B3's scale, the dropless MoE, the model -----
def _granite_reference():
    """``portbench/reference/granite_hybrid.py`` (plain torch, no JAX)."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.reference import granite_hybrid
    return granite_hybrid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1 / 128, 0.3])
def test_flash_kernel_scale_matches_plain(cuda, dtype, scale):
    """B3 with granite's softmax scale (hd 128, G 4) within FLASH_TOL of
    the plain version at the same scale, lse within 1e-4."""
    q = _randn(2, 300, 2, 4, 128, seed=60).to(cuda, dtype)
    k = _randn(2, 300, 2, 128, seed=61).to(cuda, dtype)
    v = _randn(2, 300, 2, 128, seed=62).to(cuda, dtype)
    out, lse = flash_attention(q, k, v, causal=True, scale=scale,
                               return_lse=True)
    exp, exp_lse = flash_attention_plain(q, k, v, causal=True, scale=scale,
                                         return_lse=True)
    torch.testing.assert_close(out.float(), exp.float(), **FLASH_TOL[dtype])
    torch.testing.assert_close(lse, exp_lse, atol=1e-4, rtol=1e-4)


def test_dropless_moe_on_card_matches_cpu(cuda):
    """The same routing, counts and output (f32, 1e-5) on the card."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(63)
    p = {"router": {"w": torch.randn(64, 72, generator=g)},
         "wg": torch.randn(9, 64, 48, generator=g) / 8,
         "wi": torch.randn(9, 64, 48, generator=g) / 8,
         "wo": torch.randn(9, 48, 64, generator=g) / 8}
    x = torch.randn(2, 256, 64, generator=g)
    outs, counts = [], []
    for dev in ("cpu", cuda):
        q = {"router": {"w": p["router"]["w"].to(dev)},
             **{k: p[k].to(dev) for k in ("wg", "wi", "wo")}}
        before = dict(L.moe_dropless.assigned)
        outs.append(L.moe_dropless(q, x.to(dev), top_k=10, held=range(9, 18),
                                   layer=("card", str(dev))).cpu())
        counts.append([L.moe_dropless.assigned[(("card", str(dev)), e)]
                       - before.get((("card", str(dev)), e), 0)
                       for e in range(9, 18)])
    assert counts[0] == counts[1]
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=1e-5)


def test_dropless_moe_bf16_grouped_products_on_card(cuda):
    """bf16 rows through the card's grouped products, in groups of uneven
    sizes, against the same layer in f32 on the card: output and every
    gradient within 2% of its norm (bf16's rounding of the rows, weights
    and hidden units).  The routing is the same: both take the logits in
    f32 from the same values."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(65)
    p = {"router": {"w": torch.randn(256, 72, generator=g)},
         "wg": torch.randn(9, 256, 128, generator=g) / 16,
         "wi": torch.randn(9, 256, 128, generator=g) / 16,
         "wo": torch.randn(9, 128, 256, generator=g) / 16}
    x = torch.randn(2, 300, 256, generator=g).to(torch.bfloat16)
    dy = torch.randn(2, 300, 256, generator=g)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = {"router": {"w": p["router"]["w"].to(cuda)},
             **{k: p[k].to(cuda) for k in ("wg", "wi", "wo")}}
        xd = x.to(cuda, dtype).requires_grad_(True)
        leaves = [q["router"]["w"], q["wg"], q["wi"], q["wo"], xd]
        for t in leaves:
            t.requires_grad_(True)
        out = L.moe_dropless(q, xd, top_k=10, held=range(9, 18))
        grads = torch.autograd.grad((out.float() * dy.to(cuda)).sum(), leaves)
        got[dtype] = [out, *grads]
    for a, b in zip(got[torch.bfloat16], got[torch.float32]):
        assert torch.isfinite(a).all()
        assert (a.float() - b).norm() <= 0.02 * b.norm()


def _granite_tiny(**kw):
    return get_config("granite-4.0-h-small").reduced(**kw)


def test_granite_on_card_matches_reference(cuda):
    """Reduced granite in f32 with B3's and B4's f32 kernels: loss within
    1e-5 relative and each gradient within 1e-3 of its norm of the plain
    reference on the card (the kernels sum in other orders, 2e-4 on B4's
    outputs)."""
    ref = _granite_reference()
    cfg = _granite_tiny(embedding_multiplier=12.0, residual_multiplier=0.22,
                        logits_scaling=16.0)
    model = build_model(cfg).init(torch.Generator(device=cuda).manual_seed(64))
    w = {k: p.detach().clone() for k, p in model.named_parameters()}
    spec = ref.Spec(
        hidden_size=cfg.d_model, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, intermediate_size=cfg.d_ff,
        shared_intermediate_size=cfg.shared_ff, vocab_size=cfg.vocab_size,
        layer_types=cfg.layer_types, router_experts=cfg.num_experts,
        experts_held=len(cfg.held), expert_rank=cfg.expert_rank,
        num_experts_per_tok=cfg.top_k, mamba_n_heads=cfg.ssm_heads,
        mamba_d_head=cfg.ssm_expand * cfg.d_model // cfg.ssm_heads,
        mamba_d_state=cfg.ssm_state, mamba_chunk_size=32,
        attention_multiplier=cfg.attention_multiplier,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, rms_norm_eps=cfg.norm_eps)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(65))
    n0 = (flash_attention.launches, ssd_scan.launches,
          ssd_state_pass.launches)
    model.requires_grad_(True)
    loss = model.loss({"tokens": ids, "labels": ids})
    loss.backward()
    # remat: each kernel runs in the forward and again in the recompute; the
    # recurrence once forward and once backward in each Mamba2 layer
    assert (flash_attention.launches - n0[0], ssd_scan.launches - n0[1],
            ssd_state_pass.launches - n0[2]) == (2, 6, 6)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref_loss, ref_grads = ref.loss_and_grads(spec, w, ids, list(w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
    for name, p in model.named_parameters():
        want = ref_grads[name]
        assert (p.grad - want).norm() <= 1e-3 * want.norm(), name


def test_granite_train_loop_on_card_matches_cpu(cuda):
    """Reduced granite (f32, B3 and B4 on): three TrainLoop steps on the
    card give the CPU's losses within 1e-4 relative; in bf16 the card's
    steps run and stay finite."""
    cfg = _granite_tiny()
    base = build_model(cfg).init(torch.Generator().manual_seed(66))
    losses = []
    for dev in ("cpu", cuda):
        loop = TrainLoop(cfg, global_batch=2, seq_len=128, device=dev,
                         init=lambda dev=dev: copy.deepcopy(base).to(dev))
        losses.append(loop.run(3)[2].losses)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    loop = TrainLoop(bf, global_batch=2, seq_len=128, device=cuda,
                     init=lambda: copy.deepcopy(base).to(cuda))
    got = loop.run(2)[2].losses
    assert all(math.isfinite(v) for v in got)
    np.testing.assert_allclose(got, losses[0][:2], rtol=1e-2)
