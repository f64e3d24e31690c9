"""The plain references against float64 numpy at tiny sizes."""

import numpy as np
import torch

from portbench.reference import nbody, no_tf32, wavesim


def numpy_forces(P, soft):
    d = P[None, :, :] - P[:, None, :]
    r2 = (d * d).sum(-1) + soft
    return (d * r2[..., None] ** -1.5).sum(1)


def test_nbody_forces_match_numpy(monkeypatch):
    rng = np.random.default_rng(3)
    P = rng.standard_normal((300, 3))
    # blocks of rows smaller than the array, so the loop over them runs
    monkeypatch.setattr(nbody, "_BLOCK_ELEMENTS", 300 * 64)
    got = nbody.forces(torch.from_numpy(P), 1e-3).numpy()
    want = numpy_forces(P, 1e-3)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_nbody_step_and_lower_precision():
    rng = np.random.default_rng(4)
    P = rng.standard_normal((200, 3)).astype(np.float32)
    V = (0.1 * rng.standard_normal((200, 3))).astype(np.float32)
    dt, m = 1e-3, 1 / 200
    P1, V1 = nbody.step(torch.from_numpy(P), torch.from_numpy(V), dt, m)
    V_want = V + m * numpy_forces(P.astype(np.float64), 1e-3) * dt
    assert np.allclose(V1.numpy(), V_want, rtol=0, atol=1e-12)
    assert np.allclose(P1.numpy(), P + V_want * dt, rtol=0, atol=1e-12)
    Pl, Vl = nbody.step_state_lower(torch.from_numpy(P), torch.from_numpy(V),
                                    dt, m, torch.bfloat16)
    assert Pl.dtype == Vl.dtype == torch.bfloat16
    assert torch.equal(Vl, Vl.float().to(torch.bfloat16))


def test_nbody_forces_in_lower_precision(monkeypatch):
    rng = np.random.default_rng(5)
    P = rng.standard_normal((300, 3)).astype(np.float32)
    monkeypatch.setattr(nbody, "_BLOCK_ELEMENTS", 300 * 64)
    want = numpy_forces(P.astype(np.float64), 1e-3)
    scale = np.abs(want).max()
    f32 = nbody.forces_lower(torch.from_numpy(P), torch.float32).numpy()
    assert np.abs(f32 - want).max() <= 1e-4 * scale
    bf = nbody.forces_lower(torch.from_numpy(P), torch.bfloat16)
    assert bf.dtype == torch.float32
    gap = np.abs(bf.numpy() - want).max()
    assert 1e-3 * scale < gap < 0.5 * scale
    P1, V1 = nbody.step_pairs_lower(torch.from_numpy(P), torch.zeros(300, 3),
                                    1e-3, 1 / 300, torch.bfloat16)
    assert P1.dtype == V1.dtype == torch.float32
    assert torch.equal(V1, bf * (1e-3 / 300))


def numpy_wave(um, u, steps, c):
    H, W = u.shape
    for _ in range(steps):
        un = np.zeros_like(u)
        un[1:-1, 1:-1] = (2 * u[1:-1, 1:-1] - um[1:-1, 1:-1]
                          + c * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2]
                                 + u[1:-1, 2:] - 4 * u[1:-1, 1:-1]))
        um, u = u, un
    return u


def test_wave_patches_match_numpy_whole_field():
    rng = np.random.default_rng(5)
    H, W, steps, size = 40, 36, 9, 6
    u0 = rng.standard_normal((H, W))
    um0 = rng.standard_normal((H, W))
    want = numpy_wave(um0, u0, steps, 0.25)
    corners = [(0, 0), (H - size, W - size), (17, 3), (5, 29), (20, 15)]
    with no_tf32():
        got = wavesim.patches(um0, u0, corners, size, steps, 0.25,
                              dtype=torch.float64).numpy()
    for g, (r, q) in zip(got, corners):
        assert np.abs(g - want[r:r + size, q:q + size]).max() < 1e-12


def test_wave_lower_precision_differs():
    rng = np.random.default_rng(6)
    u0 = rng.standard_normal((32, 32)).astype(np.float32)
    a = wavesim.patches(u0, u0, [(8, 8)], 8, 20, 0.25)
    b = wavesim.patches(u0, u0, [(8, 8)], 8, 20, 0.25, store=torch.bfloat16)
    assert (a - b).abs().max() > 1e-3
