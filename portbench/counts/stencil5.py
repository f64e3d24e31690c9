"""Frozen bytes of one 5-point wave step (kernel B2's algorithm).

Convention: each input byte is read once and each output byte written once,
whatever a kernel reads again.  A step over an ``H x W`` field reads the
previous field ``um`` and the current field ``u`` and writes the next field
``un``: three fields of ``H * W`` elements.  The halo rows a chunk reads
beside its own are counted once with the chunk that owns them, so the
bytes of a step do not depend on how the rows are split.
"""

FIELDS_PER_STEP = 3


def bytes_moved(rows: int, width: int, itemsize: int = 4) -> int:
    """Bytes of one step over ``rows`` rows of width ``width``."""
    return FIELDS_PER_STEP * rows * width * itemsize


def step_bytes(height: int, width: int, itemsize: int = 4) -> int:
    """Bytes of one step over the whole field."""
    return bytes_moved(height, width, itemsize)
