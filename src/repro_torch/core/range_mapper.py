# Copied from src/repro/core/range_mapper.py.
"""Range mappers: declare the buffer region a kernel chunk accesses.

A range mapper is a function ``chunk -> Region`` mapping a *chunk* of the
kernel index space (a Box) to the buffer region touched by the work items in
that chunk.  This is the metadata that makes Celerity's implicit dataflow
analysis possible (paper §2.1/§2.2).
"""

from __future__ import annotations

from typing import Callable, Sequence

from .region import Box, Region

RangeMapper = Callable[[Box, tuple[int, ...]], Region]
# signature: (kernel_chunk, buffer_shape) -> Region


def one_to_one() -> RangeMapper:
    """Kernel and buffer index space are identical."""

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        return Region.from_box(chunk.clamp(Box.full(buffer_shape)))

    rm.__name__ = "one_to_one"
    return rm


def all_range() -> RangeMapper:
    """Every chunk accesses the entire buffer (paper's ``access::all``)."""

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        return Region.from_box(Box.full(buffer_shape))

    rm.__name__ = "all"
    return rm


def fixed(region: Region | Box) -> RangeMapper:
    """Every chunk accesses a fixed subregion."""
    reg = Region.from_box(region) if isinstance(region, Box) else region

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        return reg.intersect_box(Box.full(buffer_shape))

    rm.__name__ = "fixed"
    return rm


def neighborhood(border: Sequence[int]) -> RangeMapper:
    """One-to-one widened by ``border`` elements per dimension (stencils)."""
    border = tuple(int(b) for b in border)

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        lo = tuple(a - b for a, b in zip(chunk.min, border))
        hi = tuple(a + b for a, b in zip(chunk.max, border))
        return Region.from_box(Box(lo, hi).clamp(Box.full(buffer_shape)))

    rm.__name__ = f"neighborhood{border}"
    return rm


def slice_dim(dim: int) -> RangeMapper:
    """One-to-one in ``dim``, full extent in all other dimensions."""

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        lo = [0] * len(buffer_shape)
        hi = list(buffer_shape)
        lo[dim], hi[dim] = chunk.min[dim], chunk.max[dim]
        return Region.from_box(Box(tuple(lo), tuple(hi)).clamp(Box.full(buffer_shape)))

    rm.__name__ = f"slice_dim({dim})"
    return rm


def rows_upto(row_of: Callable[[Box], int]) -> RangeMapper:
    """Access rows ``[0, row_of(chunk))`` — RSim's growing read pattern."""

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        n = row_of(chunk)
        hi = (min(n, buffer_shape[0]),) + tuple(buffer_shape[1:])
        lo = (0,) * len(buffer_shape)
        return Region.from_box(Box(lo, hi))

    rm.__name__ = "rows_upto"
    return rm


def fixed_row(row_of: Callable[[Box], int]) -> RangeMapper:
    """Access exactly row ``row_of(chunk)`` — RSim's appending write."""

    def rm(chunk: Box, buffer_shape: tuple[int, ...]) -> Region:
        n = row_of(chunk)
        lo = (n,) + (0,) * (len(buffer_shape) - 1)
        hi = (n + 1,) + tuple(buffer_shape[1:])
        return Region.from_box(Box(lo, hi).clamp(Box.full(buffer_shape)))

    rm.__name__ = "fixed_row"
    return rm
