"""Frozen work of one forward of attention (kernel B3's algorithm).

Convention, as the kernel table in PERF.md counts B3: each (query, key)
pair that the mask keeps costs ``4 hd`` operations per query head, ``2 hd``
for the logit ``q . k`` and ``2 hd`` for adding ``p v`` (a multiply-add
counted as 2); the softmax's exponentials are not counted.  Causal: query
``i`` keeps keys ``0 .. i``, so ``S (S + 1) / 2`` pairs when keys and
queries are one sequence.  The scale changes nothing here.
"""


def pairs(S: int, causal: bool = True) -> int:
    """Kept (query, key) pairs of one head over one sequence of ``S``."""
    return S * (S + 1) // 2 if causal else S * S


def flops(batch: int, S: int, heads: int, hd: int,
          causal: bool = True) -> int:
    """Operations of one forward over ``batch`` sequences of ``S``."""
    return 4 * batch * heads * hd * pairs(S, causal)
