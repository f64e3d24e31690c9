"""Kernels B1 (N-body) and B2 (wave stencil) of the torch port against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version; the CUDA
kernels themselves are checked against those plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nbody import nbody_forces_tpu
from repro.kernels.stencil5 import wave_step_tpu
from repro_torch.kernels import _build
from repro_torch.kernels.nbody import (nbody_forces_rows,
                                       nbody_forces_rows_plain)
from repro_torch.kernels.stencil5 import (halo_rows, wave_step_rows,
                                          wave_step_rows_plain, writing_into)
from torch_parity import keep_reference_ids  # noqa: F401


def _bodies(N, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(N, 3)).astype(dtype)


def _chunks(H, cuts):
    edges = [0, *cuts, H]
    return list(zip(edges[:-1], edges[1:]))


def _wave_by_chunks(step, um, u, cuts, **kw):
    """One wave step assembled from row chunks, each with its halo slab."""
    H = u.shape[0]
    parts = []
    for lo, hi in _chunks(H, cuts):
        top, bottom = halo_rows(lo, hi - lo, H)
        parts.append(step(um[lo:hi], u[lo - top:hi + bottom], lo, H, **kw))
    return torch.cat(parts)


# -- B1: N-body ---------------------------------------------------------------
@pytest.mark.parametrize("N,tile", [(64, 32), (100, 32), (256, 128), (33, 16)])
def test_nbody_plain_matches_pallas(N, tile):
    p = _bodies(N)
    exp = nbody_forces_tpu(jnp.asarray(p), tile_i=tile, tile_j=tile,
                           interpret=True)
    got = nbody_forces_rows_plain(torch.from_numpy(p), 0, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,lo,hi", [(100, 0, 50), (100, 33, 100),
                                     (257, 5, 7), (257, 256, 257),
                                     (64, 10, 10), (600, 250, 270)])
def test_nbody_rows_equal_rows_of_full(N, lo, hi):
    p = torch.from_numpy(_bodies(N, seed=1))
    full = nbody_forces_rows(p, 0, N)
    assert torch.equal(nbody_forces_rows(p, lo, hi), full[lo:hi])


def test_nbody_keeps_storage_dtype():
    p = torch.from_numpy(_bodies(50, seed=2, dtype=np.float64))
    out = nbody_forces_rows(p, 3, 20)
    assert out.dtype == torch.float64 and out.shape == (17, 3)
    f32 = nbody_forces_rows(p.float(), 3, 20)
    # computed in f32 whatever the storage type, as the TPU kernel does
    np.testing.assert_allclose(out.numpy(), f32.double().numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [(0, 101), (-1, 4), (5, 4)])
def test_nbody_rejects_bad_row_range(bad):
    with pytest.raises(ValueError):
        nbody_forces_rows(torch.zeros(100, 3), *bad)


# -- B2: wave stencil -------------------------------------------------------------
@pytest.mark.parametrize("H,W,tile", [(64, 32, 16), (100, 24, 32), (32, 16, 32)])
def test_wave_plain_matches_pallas(H, W, tile):
    rng = np.random.default_rng(3)
    um = rng.normal(size=(H, W)).astype(np.float32)
    u = rng.normal(size=(H, W)).astype(np.float32)
    exp = wave_step_tpu(jnp.asarray(um), jnp.asarray(u), tile=tile,
                        interpret=True)
    got = wave_step_rows_plain(torch.from_numpy(um), torch.from_numpy(u), 0, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,W,cuts", [(64, 32, [16, 32, 48]),
                                      (100, 24, [1, 50, 99]),
                                      (37, 9, [13]), (5, 7, [1, 2, 3, 4])])
def test_wave_chunks_reassemble_whole_field(H, W, cuts):
    rng = np.random.default_rng(4)
    um = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    whole = wave_step_rows(um, u, 0, H)
    assert torch.equal(_wave_by_chunks(wave_step_rows, um, u, cuts), whole)


def test_wave_keeps_border_zero_and_dtype():
    rng = np.random.default_rng(5)
    um = torch.from_numpy(rng.normal(size=(12, 10)))
    u = torch.from_numpy(rng.normal(size=(12, 10)))
    out = wave_step_rows(um, u, 0, 12)
    assert out.dtype == torch.float64
    for edge in (out[0], out[-1], out[:, 0], out[:, -1]):
        assert not edge.any()


@pytest.mark.parametrize("rows_ext", [10, 12])
def test_wave_rejects_wrong_halo(rows_ext):
    # chunk [4, 8) of 16 rows needs exactly one halo row on each side
    with pytest.raises(ValueError):
        wave_step_rows(torch.zeros(4, 8), torch.zeros(rows_ext, 8), 4, 16)


@pytest.mark.parametrize("H,W,cuts", [(64, 32, []), (64, 32, [16, 32, 48]),
                                      (37, 9, [1, 13, 36])])
def test_wave_writes_into_destination(H, W, cuts):
    """Under ``writing_into`` each chunk's step lands in its rows of a field
    the caller owns, as in the runtime's allocation, and the call returns
    those rows themselves, bit for bit the fresh-tensor result."""
    rng = np.random.default_rng(7)
    um = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    field = torch.full((H, W), float("nan"))
    n0 = wave_step_rows.in_place
    for lo, hi in _chunks(H, cuts):
        top, bottom = halo_rows(lo, hi - lo, H)
        args = (um[lo:hi], u[lo - top:hi + bottom], lo, H)
        with writing_into(field[lo:hi]):
            out = wave_step_rows(*args)
        assert out.data_ptr() == field[lo:hi].data_ptr()
        assert torch.equal(out, wave_step_rows_plain(*args))
    assert wave_step_rows.in_place == n0 + len(cuts) + 1
    assert torch.equal(field, wave_step_rows(um, u, 0, H))


# destinations the step must not write for the chunk [4, 12) of 24 rows,
# given um [16, 10] and u [24, 10]: none is a field's own rows it may fill
REFUSED = {"non_contiguous": lambda um, u: torch.zeros(8, 12)[:, :10],
           "transposed": lambda um, u: torch.zeros(10, 8).t(),
           "wrong_shape": lambda um, u: torch.zeros(7, 10),
           "wrong_dtype": lambda um, u: torch.zeros(8, 10, dtype=torch.float64),
           "overlaps_um": lambda um, u: um[4:12],
           "overlaps_u_ext": lambda um, u: u[5:13],
           "overlaps_u_ext_partly": lambda um, u: u[12:20]}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wave_refuses_destination(case):
    """A destination that is not contiguous, has another shape or dtype, or
    shares bytes with ``um_chunk`` or ``u_ext`` is left alone: the result is
    a fresh tensor and ``in_place`` does not count."""
    rng = np.random.default_rng(8)
    um = torch.from_numpy(rng.normal(size=(16, 10)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(24, 10)).astype(np.float32))
    dst = REFUSED[case](um, u)
    before = dst.clone()
    # chunk [4, 12) of 24 rows: um's rows 4..12, u_ext = u[3:13]
    args = (um[4:12], u[3:13], 4, 24)
    n0 = wave_step_rows.in_place
    with writing_into(dst):
        out = wave_step_rows(*args)
    assert out.data_ptr() != dst.data_ptr()
    assert torch.equal(out, wave_step_rows_plain(*args))
    assert torch.equal(dst, before)
    assert wave_step_rows.in_place == n0


def test_wave_destination_hint_stays_in_its_scope_and_thread():
    """The hint holds only inside its ``with`` block (nested blocks restore
    the outer one, also when the block raises), and only on its thread."""
    um, u = torch.ones(8, 6), torch.rand(8, 6)
    outer, inner = torch.zeros(8, 6), torch.zeros(8, 6)
    seen = []

    def step():
        return wave_step_rows(um, u, 0, 8)
    with writing_into(outer):
        thread = threading.Thread(target=lambda: seen.append(step()))
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
        with pytest.raises(KeyError), writing_into(inner):
            assert step() is inner
            raise KeyError
        assert step() is outer
    fresh = step()
    assert seen[0].data_ptr() not in (outer.data_ptr(), inner.data_ptr())
    assert fresh.data_ptr() not in (outer.data_ptr(), inner.data_ptr())
    assert torch.equal(fresh, outer) and torch.equal(seen[0], outer)


# -- wrappers, binding, build -----------------------------------------------------
def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    n0, w0 = nbody_forces_rows.launches, wave_step_rows.launches
    p = torch.from_numpy(_bodies(40, seed=6))
    assert torch.equal(nbody_forces_rows(p, 2, 9),
                       nbody_forces_rows_plain(p, 2, 9))
    um, u = torch.ones(8, 6), torch.rand(8, 6)
    assert torch.equal(wave_step_rows(um, u, 0, 8),
                       wave_step_rows_plain(um, u, 0, 8))
    assert (nbody_forces_rows.launches, wave_step_rows.launches) == (n0, w0)


def test_c_signatures_match_sources():
    """Every ctypes signature names an ``extern "C"`` entry of csrc/ with the
    same number of parameters."""
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text))
    assert set(entries) == set(_build._SIGNATURES)
    for name, args in _build._SIGNATURES.items():
        assert len(entries[name].split(",")) == len(args), name


def test_build_key_follows_sources(tmp_path, monkeypatch):
    key = _build.source_hash()
    assert _build.source_hash() == key
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() == key
    with open(tmp_path / _build.SOURCES[0], "a") as f:
        f.write("// edited\n")
    assert _build.source_hash() != key
