"""The frozen counts against sums by hand at small shapes."""

from portbench.counts import nbody, peaks, stencil5


def test_nbody_flops_by_hand():
    # 3 rows against 5 bodies: 15 pairs, each 3 sub, 3 fma (6), rsqrt,
    # 2 mul, 3 fma (6) = 18 operations
    assert nbody.pairs(3, 5) == 15
    assert nbody.flops(3, 5) == 15 * (3 + 6 + 1 + 2 + 6)
    assert nbody.step_flops(4) == 4 * 4 * 18


def test_nbody_split_rows_add_up():
    n = 1 << 10
    assert sum(nbody.flops(n // 4, n) for _ in range(4)) == nbody.step_flops(n)


def test_stencil_bytes_by_hand():
    # a 4 x 6 float32 field: read um and u, write un, 4 bytes each
    assert stencil5.step_bytes(4, 6) == (24 + 24 + 24) * 4
    assert stencil5.bytes_moved(2, 6, itemsize=8) == 3 * 12 * 8
    assert sum(stencil5.bytes_moved(8, 16) for _ in range(4)) \
        == stencil5.step_bytes(32, 16)


def test_peaks_are_the_data_sheet_rates():
    p = peaks()
    assert p["float32_flops_per_s"] == 67e12
    assert p["hbm_bytes_per_s"] == 3.35e12
