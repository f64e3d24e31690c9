# Copied from src/repro/core/reduction.py.
"""Reduction operators and reproducible accumulators (paper §2.2/§4).

Celerity treats reductions as first-class graph nodes: a kernel binds a
*reduction output* next to its accessors, every device produces a partial
value, node-local partials are combined, exchanged between all ranks and
folded into the final replicated buffer value.  This module defines the
*value semantics* of that pipeline; the graph layers (task graph, command
graph, instruction graph) and the executor wire it through the runtime.

Determinism contract
--------------------

The command graph is replicated-deterministic, so all ranks must compute a
**bitwise identical** reduction result — and our acceptance tests further
require the result to be *partition independent*: the same bits on 1, 2 and
4 simulated nodes.  Floating-point addition is not associative, so folding
per-chunk float partials can never satisfy that.  Instead:

* ``sum`` over float buffers uses an **exact fixed-point superaccumulator**
  (the ReproBLAS idea, radically simplified for arbitrary-precision Python
  integers): every finite float64 is an integer multiple of 2^-1074, so each
  contribution is scaled to an exact integer and partials are exact integer
  sums.  Integer addition is associative and commutative, and the single
  final rounding (via ``Fraction``) is correctly rounded — the result equals
  ``math.fsum`` of all contributions in any partition and any combine order.
* ``max``/``min`` are associative, commutative and exact on floats already;
  partials are plain element-wise folds.
* ``prod`` and custom callables fold partials in canonical node order —
  deterministic and replicated-identical, but (like any real MPI allreduce
  of floats) not partition independent; see DESIGN.md §7.

Accumulator state is an ndarray of the reduction-buffer shape: dtype
``object`` holding Python ints for the exact-sum path, the buffer dtype
otherwise.  On a real MPI wire the integer limbs would be serialized like
ReproBLAS bins; the in-process mailbox ships the object array directly.

Transport note (DESIGN.md §9): with the collective layer enabled the node
partials travel as packed fragments of a dissemination allgather (fused
across adjacent reductions) instead of N*(N-1) point-to-point sends.
Integer addition stays associative/commutative, so the exchange topology
— p2p, collective, fused or not — never changes a single bit of the
result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Optional, Union

import numpy as np

# every finite double is n * 2^-_SCALE_BITS for an integer n
_SCALE_BITS = 1074


def _float_to_fixed(v: float) -> int:
    """Exact integer n with ``v == n * 2**-1074`` (finite doubles only)."""
    v = float(v)
    if not math.isfinite(v):
        raise ValueError(f"non-finite contribution {v!r} in exact-sum reduction")
    m, e = math.frexp(v)
    n = int(m * (1 << 53))           # exact: m has <= 53 significant bits
    s = e - 53 + _SCALE_BITS
    return n << s if s >= 0 else n >> (-s)   # negative shifts are exact too


def _fixed_to_float(n: int) -> float:
    """Correctly-rounded double for ``n * 2**-1074``."""
    if n == 0:
        return 0.0
    return float(Fraction(n, 1 << _SCALE_BITS))


def _float_fixed_parts(values: np.ndarray):
    """Vectorized decomposition of finite float64s on the 2^-1074 grid.

    Returns ``(sign, a, s)`` int64 arrays with ``v == sign * a * 2**(s-1074)``
    exactly, ``a < 2**53`` and ``s >= 0``: ``frexp`` yields ``v = m * 2**e``
    with ``m`` holding <= 53 significant bits, so ``a = |m| * 2**53`` is an
    exact int64 and ``s = e - 53 + 1074``.  Subnormals produce ``s < 0``
    with enough trailing zero bits in ``a`` for an exact right shift.
    """
    values = np.ascontiguousarray(values, dtype=np.float64)
    if not np.isfinite(values).all():
        bad = values[~np.isfinite(values)].ravel()[0]
        raise ValueError(f"non-finite contribution {bad!r} in exact-sum reduction")
    m, e = np.frexp(values)
    n = (m * float(1 << 53)).astype(np.int64)        # exact: integer-valued
    sign = np.sign(n)
    a = np.abs(n)
    s = e.astype(np.int64) - 53 + _SCALE_BITS
    neg = s < 0
    if neg.any():
        a = np.where(neg, a >> np.where(neg, -s, 0), a)
        s = np.where(neg, 0, s)
    return sign, a, s


def _exact_scale(values: np.ndarray) -> np.ndarray:
    """Element-wise exact fixed-point lift into object dtype.

    Integer inputs lift as ``int(v) << 1074`` (exact for any int64, unlike
    a cast through float64 which silently rounds above 2^53); floats use
    the vectorized frexp decomposition with one big-int shift per element.
    Both land on the same 2^-1074 fixed-point grid, so partials mix freely.
    """
    values = np.asarray(values)
    flat = values.ravel()
    out = np.empty(flat.shape, dtype=object)
    if np.issubdtype(values.dtype, np.integer):
        for i, v in enumerate(flat):
            out[i] = int(v) << _SCALE_BITS
    else:
        sign, a, s = _float_fixed_parts(flat)
        for i in range(flat.size):
            out[i] = int(sign[i]) * (int(a[i]) << int(s[i]))
    return out.reshape(values.shape)


# two-level binned accumulator (ReproBLAS-style): level 1 sums signed 32-bit
# limbs of each contribution into int64 bins (pure numpy, no Python ints on
# the per-element path); level 2 folds the bins into one arbitrary-precision
# integer per output element with a single carry pass.  2098 significant bits
# (s <= 2045, 53-bit mantissa) span ceil(2098/32) = 66 limbs; +2 slack.
_NBINS = 68
# each limb contribution is < 2^32, so int64 bins absorb 2^31 additions
# before overflow could occur — chunk longer inputs
_BIN_CHUNK = 1 << 30


def _exact_scale_sum(values: np.ndarray) -> np.ndarray:
    """Exact fixed-point sum over the leading axis, fully vectorized.

    ``values`` has shape ``(n_items, *out_shape)``; the result is an object
    ndarray of Python ints with shape ``out_shape``, bitwise identical to
    ``_exact_scale(values).sum(axis=0)`` (both are exact integer sums on the
    same grid — the fast path changes the work, not the value).
    """
    values = np.asarray(values, dtype=np.float64)
    out_shape = values.shape[1:]
    size = int(np.prod(out_shape, dtype=np.int64)) if out_shape else 1
    flat = values.reshape(values.shape[0], size)
    out = np.zeros(size, dtype=object)
    for lo in range(0, flat.shape[0], _BIN_CHUNK):
        chunk = flat[lo:lo + _BIN_CHUNK]
        # fresh bins per chunk: each row contributes at most one limb
        # (< 2^32) per bin, so 2^30 rows stay below the int64 overflow
        # threshold; the level-2 big-int fold below drains them
        bins = np.zeros((_NBINS, size), dtype=np.int64)
        pos = np.broadcast_to(np.arange(size, dtype=np.int64), chunk.shape)
        sign, a, s = _float_fixed_parts(chunk)
        q, r = s >> 5, s & 31
        # |a| << r spans up to 85 bits -> three 32-bit limbs, computed
        # without ever overflowing int64 (shift counts stay < 64)
        c0 = (a & ((np.int64(1) << (32 - r)) - 1)) << r
        c1 = (a >> (32 - r)) & np.int64(0xFFFFFFFF)
        c2 = (a >> 32) >> (32 - r)
        np.add.at(bins, (q, pos), sign * c0)
        np.add.at(bins, (q + 1, pos), sign * c1)
        np.add.at(bins, (q + 2, pos), sign * c2)
        for j in range(size):
            col = bins[:, j]
            total = 0
            for k in np.nonzero(col)[0]:
                total += int(col[k]) << (32 * int(k))
            out[j] += total
    return out.reshape(out_shape)


class ReductionOp:
    """Value semantics of one reduction operator.

    The accumulator array (``acc``) has the reduction-buffer shape.  All
    methods are pure element-wise transforms; ``combine`` must be
    deterministic when folded in canonical node order.
    """

    def __init__(self, name: str, *, exact_sum: bool,
                 fold: Optional[Callable] = None, identity=None,
                 order_free: bool = False):
        self.name = name
        self.exact_sum = exact_sum
        self._fold = fold                    # binary elementwise fold
        self._identity = identity
        # ``combine`` is associative, commutative AND exact: any combine
        # tree yields bitwise identical results.  True for the exact-sum
        # superaccumulator (integer addition) and max/min (elementwise
        # selection); False for float prod and custom callables, whose
        # results depend on the canonical fold order.  Gates the
        # reduce-scatter allreduce (DESIGN.md §9), whose recursive-halving
        # fold tree is not the canonical node order.
        self.combine_order_free = exact_sum or order_free

    # -- accumulator lifecycle -------------------------------------------
    def acc_dtype(self, buf_dtype: np.dtype) -> np.dtype:
        return np.dtype(object) if self.exact_sum else np.dtype(buf_dtype)

    def identity_acc(self, shape: tuple[int, ...], buf_dtype: np.dtype) -> np.ndarray:
        if self.exact_sum:
            acc = np.empty(shape, dtype=object)
            acc[...] = 0
            return acc
        acc = np.empty(shape, dtype=buf_dtype)
        acc[...] = self.identity_value(buf_dtype)
        return acc

    def identity_value(self, buf_dtype: np.dtype):
        if self._identity is not None:
            return self._identity
        if self.exact_sum:
            return 0
        if self.name in ("max", "min"):
            # dtype-aware default: +/-inf only exists for floats
            if np.issubdtype(buf_dtype, np.integer):
                info = np.iinfo(buf_dtype)
                return info.min if self.name == "max" else info.max
            return -np.inf if self.name == "max" else np.inf
        if self.name == "prod":
            return buf_dtype.type(1)
        raise ValueError(f"reduction op '{self.name}' needs an explicit identity")

    # -- the three pipeline steps ----------------------------------------
    @staticmethod
    def _stack(acc: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Normalize ``values`` to shape ``(n_items,) + acc.shape``."""
        if acc.size == 1:
            return values.reshape((-1,) + acc.shape)
        if values.shape == acc.shape:
            return values[None]
        if values.ndim == acc.ndim + 1 and values.shape[1:] == acc.shape:
            return values
        raise ValueError(f"contribution shape {values.shape} does not match "
                         f"reduction shape {acc.shape}")

    def contribute(self, acc: np.ndarray, values: np.ndarray) -> None:
        """Fold ``values`` (leading axis = per-item contributions) into acc."""
        values = self._stack(acc, np.asarray(values))
        if not values.size:
            return
        if self.exact_sum:
            if (np.issubdtype(values.dtype, np.integer)
                    or values.dtype == np.dtype(object)):
                acc += _exact_scale(values).sum(axis=0)
            else:
                # vectorized two-level binned accumulation; bitwise
                # identical to the elementwise lift (both exact)
                acc += _exact_scale_sum(values)
        elif isinstance(self._fold, np.ufunc):
            acc[...] = self._fold(
                acc, self._fold.reduce(values.astype(acc.dtype, copy=False),
                                       axis=0))
        else:
            folder = np.frompyfunc(self._fold, 2, 1)
            folded = folder.reduce(values.astype(acc.dtype, copy=False), axis=0)
            acc[...] = self._fold(acc, folded.astype(acc.dtype, copy=False))

    def combine(self, acc: np.ndarray, other: np.ndarray) -> np.ndarray:
        """Merge two accumulators (exact for sum/max/min)."""
        if self.exact_sum:
            return acc + other
        return self._fold(acc, other)

    def lift(self, values: np.ndarray, buf_dtype: np.dtype) -> np.ndarray:
        """Lift plain buffer values into accumulator space
        (``include_current_value`` support)."""
        if self.exact_sum:
            return _exact_scale(values)
        return np.asarray(values, dtype=buf_dtype)

    def finalize(self, acc: np.ndarray, buf_dtype: np.dtype) -> np.ndarray:
        """Round the accumulator back to buffer dtype (single rounding)."""
        if self.exact_sum:
            flat_in = acc.ravel()
            if np.issubdtype(buf_dtype, np.integer):
                # exact: integer-lifted sums are multiples of 2^1074
                out = np.empty(acc.shape, dtype=buf_dtype)
                flat_out = out.ravel()
                for i in range(flat_in.size):
                    flat_out[i] = int(Fraction(flat_in[i], 1 << _SCALE_BITS))
                return out
            out = np.empty(acc.shape, dtype=np.float64)
            flat_out = out.ravel()
            for i in range(flat_in.size):
                flat_out[i] = _fixed_to_float(flat_in[i])
            return out.astype(buf_dtype, copy=False)
        return np.asarray(acc, dtype=buf_dtype)


def _make_op(op: Union[str, Callable], identity) -> ReductionOp:
    if callable(op):
        if identity is None:
            raise ValueError("custom reduction callables require an identity")
        return ReductionOp(getattr(op, "__name__", "custom"), exact_sum=False,
                           fold=op, identity=identity)
    if op == "sum":
        return ReductionOp("sum", exact_sum=True)
    if op == "max":
        return ReductionOp("max", exact_sum=False, fold=np.maximum,
                           identity=identity, order_free=True)
    if op == "min":
        return ReductionOp("min", exact_sum=False, fold=np.minimum,
                           identity=identity, order_free=True)
    if op == "prod":
        return ReductionOp("prod", exact_sum=False, fold=np.multiply,
                           identity=identity)
    raise ValueError(f"unknown reduction op {op!r}")


@dataclass(frozen=True)
class Reduction:
    """User-facing reduction descriptor — bound by kernels like an accessor.

    The kernel receives a :class:`~repro.core.executor.ReductionView` in
    binding order (after plain accessor views) and calls
    ``view.contribute(values)`` with per-item contributions; the runtime
    owns the partial/exchange/combine pipeline.  ``include_current_value``
    folds the buffer's pre-reduction contents into the result exactly once.
    """

    buffer: object                   # VirtualBuffer (untyped: avoid cycle)
    op: ReductionOp
    include_current_value: bool = False

    def __repr__(self) -> str:
        return (f"Reduction({self.buffer.name}, {self.op.name}"
                f"{', +current' if self.include_current_value else ''})")


def reduction(buffer, op: Union[str, Callable] = "sum", identity=None, *,
              include_current_value: bool = False) -> Reduction:
    """Create a reduction descriptor: ``reduction(E, 'sum')``.

    ``op`` is ``'sum' | 'max' | 'min' | 'prod'`` or a binary element-wise
    callable (requires ``identity``).  ``'sum'`` over float buffers is
    *reproducible*: bitwise identical on any node/device partition.
    """
    return Reduction(buffer=buffer, op=_make_op(op, identity),
                     include_current_value=include_current_value)
