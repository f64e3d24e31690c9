"""Frozen bytes of one forward of the SSD scan (kernel B4's algorithm),
as the kernel table in PERF.md bounds B4: each input read once and each
output written once, ``x [b,s,h,p]``, ``B`` and ``C`` ``[b,s,n]`` and ``y``
in the activation dtype, the log-decays ``a [b,s,h]`` and the final state
``[b,h,p,n]`` in float32.
"""

F32 = 4


def bytes_moved(b: int, s: int, h: int, p: int, n: int,
                itemsize: int = 2) -> int:
    reads = (b * s * h * p + 2 * b * s * n) * itemsize + b * s * h * F32
    writes = b * s * h * p * itemsize + b * h * p * n * F32
    return reads + writes
