"""Frozen work of one all-pairs gravity step (kernel B1's algorithm).

Convention: every ordered pair (i, j) of the N bodies is one interaction,
self-pairs included, since the algorithm sums over all j for each i and a
self-pair adds zero.  One interaction costs 18 float32 operations, a fused
multiply-add counted as 2:

- 3 subtractions for the difference d = p_j - p_i,
- 3 multiply-adds for r^2 = d.d + soft (the softening added as one of them),
- 1 reciprocal square root,
- 2 multiplications for w = (1/r)^3,
- 3 multiply-adds for f += d * w (6 operations),
- counted as 3 + 6 + 1 + 2 + 6 = 18.

These counts belong to the algorithm and not to a kernel: a kernel that does
the same work reads against the same numbers.
"""

FLOPS_PER_PAIR = 18


def pairs(rows: int, bodies: int) -> int:
    """Interactions of ``rows`` bodies with all ``bodies``."""
    return rows * bodies


def flops(rows: int, bodies: int) -> int:
    """Floating-point operations of the forces on ``rows`` bodies."""
    return FLOPS_PER_PAIR * pairs(rows, bodies)


def step_flops(bodies: int) -> int:
    """Floating-point operations of the forces of one whole step."""
    return flops(bodies, bodies)
