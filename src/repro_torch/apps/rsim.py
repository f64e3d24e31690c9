"""RSim (``examples/rsim_lookahead.py``) on the port's runtime: a radiosity
pattern whose buffer grows by one row per time step, the adversarial case
for ad-hoc memory management (paper §4.3 / §5).  Step ``t`` reads rows
``[0, t)`` of its column range and writes row ``t``; with scheduler
lookahead the runtime sizes each device's allocation once instead of
resizing it every step.
"""

from __future__ import annotations

import numpy as np

from ..core import Box, Region, Runtime, fixed, read, write


def row_cols(t: int):
    """Range mapper: row ``t`` of the chunk's columns."""
    def rm(chunk, shape):
        return Region.from_box(Box((t, chunk.min[1]), (t + 1, chunk.max[1])))
    rm.__name__ = f"row_cols({t})"
    return rm


def radiosity_kernel(t: int):
    """Row ``t`` = half the column sums of rows ``[0, t)`` plus one (ones for
    ``t = 0``)."""
    def radiosity(chunk, prev, row):
        lo, hi = chunk.min[1], chunk.max[1]
        if t == 0:
            vals = np.ones(hi - lo)
        else:
            vals = prev.get(Box((0, lo), (t, hi))).sum(0) * 0.5 + 1.0
        row.set(Box((t, lo), (t + 1, hi)), vals)
    return radiosity


def run_rsim(T: int, W: int, *, lookahead: bool, dtype=np.float64,
             device="cuda"):
    """The program on one node with two devices, the columns split over
    them: ``T`` steps over a ``[T, W]`` buffer of ``dtype``.  Returns the
    field, ``Runtime.total_allocs()`` and the lookahead statistics."""
    with Runtime(num_nodes=1, devices_per_node=2, lookahead=lookahead,
                 device=device) as rt:
        R = rt.buffer((T, W), dtype=dtype, init=np.zeros((T, W), dtype),
                      name="radiosity")
        for t in range(T):
            rt.submit(f"radiosity{t}", Box((0, 0), (1, W)),
                      [read(R, fixed(Box((0, 0), (max(t, 1), W)))),
                       write(R, row_cols(t))],
                      radiosity_kernel(t), split_dims=(1,))
        field = rt.gather(R)
        allocs = rt.total_allocs()
        stats = rt.schedulers[0].lookahead.stats
    return field, allocs, stats
