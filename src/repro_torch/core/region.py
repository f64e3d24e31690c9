# Copied from src/repro/core/region.py.
"""Box/region algebra for buffer subrange tracking.

Celerity tracks dataflow at the granularity of individual buffer elements by
operating on *regions*: finite unions of pairwise-disjoint, half-open,
axis-aligned N-dimensional boxes.  Every layer of the scheduler (task graph,
command graph, instruction graph) is built on this algebra, so it must be
exact — the hypothesis test-suite checks it against a brute-force bitmap
oracle.

Boxes are represented as ``(min, max)`` tuples of per-dimension integers with
half-open semantics ``min <= i < max``.  Empty boxes are normalized away.

Performance notes (see DESIGN.md "Performance notes"):

* Regions produced by the algebra itself (``intersect``, ``difference``,
  ``union``, ``intersect_box``) are disjoint *by construction*, so internal
  call sites build results through the trusted :meth:`Region.from_disjoint`
  constructor and never pay the quadratic renormalization of the public
  ``Region(boxes)`` constructor.
* All pairwise loops are prefiltered by cached bounding boxes; the all-pairs
  work only happens for boxes whose bounding boxes actually overlap.
* Box-merging uses a sort-and-sweep (group by the N-1 invariant coordinates,
  merge touching intervals along the remaining axis), replacing the previous
  greedy O(n^3) loop.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence


class Box:
    """A half-open axis-aligned box ``[min, max)`` in N dimensions.

    Immutable by convention (do not assign to ``min``/``max``): a plain
    slotted class instead of a frozen dataclass because Box construction is
    the single hottest operation of the whole scheduler.
    """

    __slots__ = ("min", "max")

    def __init__(self, min: tuple[int, ...], max: tuple[int, ...]):  # noqa: A002
        if len(min) != len(max):
            raise ValueError(f"rank mismatch: {min} vs {max}")
        self.min = min
        self.max = max

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Box):
            return NotImplemented
        return self.min == other.min and self.max == other.max

    def __hash__(self) -> int:
        return hash((self.min, self.max))

    def __repr__(self) -> str:
        return f"Box(min={self.min}, max={self.max})"

    @staticmethod
    def make(min_: Sequence[int], max_: Sequence[int]) -> "Box":
        return Box(tuple(int(m) for m in min_), tuple(int(m) for m in max_))

    @staticmethod
    def full(shape: Sequence[int]) -> "Box":
        return Box((0,) * len(shape), tuple(int(s) for s in shape))

    @property
    def rank(self) -> int:
        return len(self.min)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.min, self.max))

    def volume(self) -> int:
        v = 1
        for a, b in zip(self.min, self.max):
            if b <= a:
                return 0
            v *= b - a
        return v

    def empty(self) -> bool:
        for a, b in zip(self.min, self.max):
            if b <= a:
                return True
        return False

    def contains(self, other: "Box") -> bool:
        if other.empty():
            return True
        return all(a <= oa and ob <= b for a, oa, ob, b in
                   zip(self.min, other.min, other.max, self.max))

    def contains_point(self, pt: Sequence[int]) -> bool:
        return all(a <= p < b for a, p, b in zip(self.min, pt, self.max))

    def intersect(self, other: "Box") -> "Box":
        lo = tuple(map(max, self.min, other.min))
        hi = tuple(map(max, lo, map(min, self.max, other.max)))  # clamp empty
        return Box(lo, hi)

    def overlaps(self, other: "Box") -> bool:
        return _boxes_overlap(self, other)

    def union_bbox(self, other: "Box") -> "Box":
        if self.empty():
            return other
        if other.empty():
            return self
        return Box(tuple(min(a, b) for a, b in zip(self.min, other.min)),
                   tuple(max(a, b) for a, b in zip(self.max, other.max)))

    def translate(self, offset: Sequence[int]) -> "Box":
        return Box(tuple(a + o for a, o in zip(self.min, offset)),
                   tuple(b + o for b, o in zip(self.max, offset)))

    def clamp(self, bounds: "Box") -> "Box":
        return self.intersect(bounds)

    def difference(self, other: "Box") -> list["Box"]:
        """``self \\ other`` as a list of disjoint boxes (axis-sweep split)."""
        inter = self.intersect(other)
        if inter.empty():
            return [] if self.empty() else [self]
        if inter == self:
            return []
        out: list[Box] = []
        cur = self
        for d in range(self.rank):
            # slab below the intersection along dim d
            if cur.min[d] < inter.min[d]:
                lo, hi = list(cur.min), list(cur.max)
                hi[d] = inter.min[d]
                out.append(Box(tuple(lo), tuple(hi)))
            # slab above
            if inter.max[d] < cur.max[d]:
                lo, hi = list(cur.min), list(cur.max)
                lo[d] = inter.max[d]
                out.append(Box(tuple(lo), tuple(hi)))
            # narrow current to the intersection along dim d and continue
            lo, hi = list(cur.min), list(cur.max)
            lo[d], hi[d] = inter.min[d], inter.max[d]
            cur = Box(tuple(lo), tuple(hi))
        return [b for b in out if not b.empty()]

    def __str__(self) -> str:  # compact debug form: [0,4)x[2,8)
        return "x".join(f"[{a},{b})" for a, b in zip(self.min, self.max))


def _boxes_overlap(a: Box, b: Box) -> bool:
    """Open-interval overlap test — no Box construction on the hot path."""
    for a0, a1, b0, b1 in zip(a.min, a.max, b.min, b.max):
        if a0 >= b1 or b0 >= a1 or a0 >= a1 or b0 >= b1:
            return False
    return True


def _subtract_boxes(pending: list[Box], boxes: Iterable[Box]) -> list[Box]:
    """Subtract each of ``boxes`` from every box in ``pending``.

    Bbox-prefiltered: only overlapping pairs pay for ``Box.difference``.
    Returns the (possibly empty) disjoint remainder; early-outs when it
    empties.  Shared kernel of normalization, ``contains_box`` and ``union``.
    """
    for x in boxes:
        nxt: list[Box] = []
        for p in pending:
            if _boxes_overlap(p, x):
                nxt.extend(p.difference(x))
            else:
                nxt.append(p)
        pending = nxt
        if not pending:
            break
    return pending


def _merge_adjacent(boxes: list[Box]) -> list[Box]:
    """Merge mergeable boxes in a *pairwise-disjoint* list (sort-and-sweep).

    For each axis, boxes sharing the same extent in every other dimension are
    grouped and their intervals along that axis merged where they touch.
    Axes are swept repeatedly until a fixpoint, since a merge along one axis
    can enable a merge along another; each sweep is O(n log n).
    """
    boxes = [b for b in boxes if not b.empty()]
    if len(boxes) <= 1:
        return boxes
    rank = boxes[0].rank
    changed = True
    while changed:
        changed = False
        for d in range(rank):
            if len(boxes) <= 1:
                break
            groups: dict[tuple, list[Box]] = {}
            for b in boxes:
                key = b.min[:d] + b.min[d + 1:] + b.max[:d] + b.max[d + 1:]
                groups.setdefault(key, []).append(b)
            out: list[Box] = []
            for bs in groups.values():
                if len(bs) == 1:
                    out.append(bs[0])
                    continue
                bs.sort(key=lambda x: x.min[d])
                cur = bs[0]
                for b in bs[1:]:
                    if b.min[d] == cur.max[d]:    # touching: merge intervals
                        cur = Box(cur.min, cur.max[:d] + (b.max[d],)
                                  + cur.max[d + 1:])
                        changed = True
                    else:
                        out.append(cur)
                        cur = b
                out.append(cur)
            boxes = out
    return boxes


class Region:
    """A finite union of pairwise-disjoint boxes. Immutable."""

    __slots__ = ("boxes", "_hash", "_bbox")

    def __init__(self, boxes: Iterable[Box] = ()):  # normalizes to disjoint
        disjoint: list[Box] = []
        for b in boxes:
            if not b.empty():
                disjoint.extend(_subtract_boxes([b], disjoint))
        self.boxes: tuple[Box, ...] = tuple(_merge_adjacent(disjoint))
        self._hash: int | None = None
        self._bbox: Box | None = None

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_disjoint(cls, boxes: Iterable[Box]) -> "Region":
        """Trusted constructor: the caller guarantees ``boxes`` are already
        pairwise disjoint and non-empty; normalization is skipped entirely.

        Every internal algebra result (intersection of disjoint regions,
        difference remainders, ...) is disjoint by construction, which is
        what keeps renormalization off the scheduling fast path.
        """
        r = object.__new__(cls)
        r.boxes = tuple(boxes)
        r._hash = None
        r._bbox = None
        return r

    @staticmethod
    def from_box(b: Box) -> "Region":
        if b.empty():
            return _EMPTY
        return Region.from_disjoint((b,))

    @staticmethod
    def empty() -> "Region":
        return _EMPTY

    # -- predicates --------------------------------------------------------
    def is_empty(self) -> bool:
        return not self.boxes

    def volume(self) -> int:
        return sum(b.volume() for b in self.boxes)

    @property
    def rank(self) -> int:
        return self.boxes[0].rank if self.boxes else 0

    def bounding_box(self) -> Box:
        bb = self._bbox
        if bb is None:
            bs = self.boxes
            if not bs:
                raise ValueError("empty region has no bounding box")
            if len(bs) == 1:                   # single-box regions dominate
                bb = bs[0]
            else:
                lo, hi = bs[0].min, bs[0].max
                for b in bs[1:]:
                    lo = tuple(map(min, lo, b.min))
                    hi = tuple(map(max, hi, b.max))
                bb = Box(lo, hi)
            self._bbox = bb
        return bb

    def contains(self, other: "Region") -> bool:
        if not other.boxes:
            return True
        if not self.boxes:
            return False
        if not self.bounding_box().contains(other.bounding_box()):
            return False
        return all(self.contains_box(b) for b in other.boxes)

    def contains_box(self, b: Box) -> bool:
        if b.empty():
            return True
        if not self.boxes:
            return False
        for x in self.boxes:                       # single-box fast path
            if x.contains(b):
                return True
        if not self.bounding_box().contains(b):
            return False
        return not _subtract_boxes([b], self.boxes)

    def overlaps(self, other: "Region") -> bool:
        if not self.boxes or not other.boxes:
            return False
        if not _boxes_overlap(self.bounding_box(), other.bounding_box()):
            return False
        obb = other.bounding_box()
        for a in self.boxes:
            if not _boxes_overlap(a, obb):
                continue
            for b in other.boxes:
                if _boxes_overlap(a, b):
                    return True
        return False

    # -- algebra -----------------------------------------------------------
    def union(self, other: "Region") -> "Region":
        if not self.boxes:
            return other
        if not other.boxes:
            return self
        sbb = self.bounding_box()
        if not _boxes_overlap(sbb, other.bounding_box()):
            # disjoint bounding boxes: concatenation is already disjoint
            # (boxes may still be adjacent, so merge for compactness)
            return Region.from_disjoint(
                _merge_adjacent(list(self.boxes + other.boxes)))
        out = list(self.boxes)
        for b in other.boxes:
            if _boxes_overlap(b, sbb):
                out.extend(_subtract_boxes([b], self.boxes))
            else:
                out.append(b)
        return Region.from_disjoint(_merge_adjacent(out))

    def intersect(self, other: "Region") -> "Region":
        if not self.boxes or not other.boxes:
            return _EMPTY
        if len(self.boxes) == 1 and len(other.boxes) == 1:
            i = self.boxes[0].intersect(other.boxes[0])
            return Region.from_disjoint((i,)) if not i.empty() else _EMPTY
        obb = other.bounding_box()
        if not _boxes_overlap(self.bounding_box(), obb):
            return _EMPTY
        # intersections of two disjoint families are pairwise disjoint
        out: list[Box] = []
        for a in self.boxes:
            if not _boxes_overlap(a, obb):
                continue
            for b in other.boxes:
                if _boxes_overlap(a, b):
                    out.append(a.intersect(b))
        if not out:
            return _EMPTY
        if len(out) > 1:
            out = _merge_adjacent(out)
        return Region.from_disjoint(out)

    def intersect_box(self, box: Box) -> "Region":
        if not self.boxes or box.empty():
            return _EMPTY
        if len(self.boxes) == 1:
            i = self.boxes[0].intersect(box)
            return Region.from_disjoint((i,)) if not i.empty() else _EMPTY
        if not _boxes_overlap(self.bounding_box(), box):
            return _EMPTY
        out = [a.intersect(box) for a in self.boxes if _boxes_overlap(a, box)]
        if not out:
            return _EMPTY
        if len(out) > 1:
            out = _merge_adjacent(out)
        return Region.from_disjoint(out)

    def difference(self, other: "Region") -> "Region":
        if not self.boxes:
            return _EMPTY
        if not other.boxes:
            return self
        sbb = self.bounding_box()
        if not _boxes_overlap(sbb, other.bounding_box()):
            return self
        cur = list(self.boxes)
        changed = False
        for b in other.boxes:
            if not cur:
                break
            if not _boxes_overlap(sbb, b):
                continue
            nxt: list[Box] = []
            for a in cur:
                if _boxes_overlap(a, b):
                    nxt.extend(a.difference(b))
                    changed = True
                else:
                    nxt.append(a)
            cur = nxt
        if not changed:
            return self
        if not cur:
            return _EMPTY
        return Region.from_disjoint(_merge_adjacent(cur))

    # -- dunder ------------------------------------------------------------
    def __iter__(self) -> Iterator[Box]:
        return iter(self.boxes)

    def __len__(self) -> int:
        return len(self.boxes)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Region):
            return NotImplemented
        if self.boxes == other.boxes:
            return True
        if not self.boxes or not other.boxes:
            return False                        # exactly one side is empty
        if self.volume() != other.volume():
            return False
        if self.bounding_box() != other.bounding_box():
            return False
        # equal finite volumes: self ⊆ other already implies equality
        return self.difference(other).is_empty()

    def __hash__(self) -> int:
        # canonical for set-equal regions: any normalization of the same
        # point set shares volume and bounding box (collisions are fine)
        if self._hash is None:
            if not self.boxes:
                self._hash = hash(())
            else:
                bb = self.bounding_box()
                self._hash = hash((self.volume(), bb.min, bb.max))
        return self._hash

    def __str__(self) -> str:
        return "{" + ", ".join(str(b) for b in self.boxes) + "}"

    __repr__ = __str__


_EMPTY = Region.from_disjoint(())


class RegionMap:
    """Maps every point of a bounded index space to a value.

    Implemented as a list of ``(Region, value)`` entries with disjoint
    regions, kept sorted by bounding-box minimum with a parallel bounding-box
    index so ``query``/``update`` touch only candidate entries.
    ``update(region, value)`` overwrites previous values in that region —
    exactly the structure Celerity uses to track last writers, up-to-date
    memories, etc.
    """

    __slots__ = ("bounds", "entries", "default", "_bbs")

    def __init__(self, bounds: Box, default=None):
        self.bounds = bounds
        self.default = default
        self.entries: list[tuple[Region, object]] = []
        self._bbs: list[Box] = []
        if default is not None:
            self.entries.append((Region.from_box(bounds), default))
            self._bbs.append(bounds)

    def _set_entries(self, pairs: list[tuple[Region, object]]) -> None:
        pairs.sort(key=lambda rv: rv[0].bounding_box().min)
        self.entries = pairs
        self._bbs = [r.bounding_box() for r, _ in pairs]

    def update(self, region: Region, value) -> None:
        region = region.intersect_box(self.bounds)
        if region.is_empty():
            return
        qbb = region.bounding_box()
        new_entries: list[tuple[Region, object]] = []
        for (r, v), bb in zip(self.entries, self._bbs):
            if not _boxes_overlap(bb, qbb):
                new_entries.append((r, v))
                continue
            rem = r.difference(region)
            if not rem.is_empty():
                new_entries.append((rem, v))
        new_entries.append((region, value))
        self._set_entries(new_entries)

    def query(self, region: Region) -> list[tuple[Region, object]]:
        """All (subregion, value) pairs intersecting ``region``."""
        if region.is_empty() or not self.entries:
            return []
        qbb = region.bounding_box()
        q0max = qbb.max[0]
        out = []
        for (r, v), bb in zip(self.entries, self._bbs):
            if bb.min[0] >= q0max:
                break          # entries sorted by bbox min: no more overlaps
            if not _boxes_overlap(bb, qbb):
                continue
            i = r.intersect(region)
            if not i.is_empty():
                out.append((i, v))
        return out

    def covered(self) -> Region:
        boxes = [b for r, _ in self.entries for b in r.boxes]
        if not boxes:
            return _EMPTY
        return Region.from_disjoint(_merge_adjacent(boxes))

    def coalesce(self) -> None:
        """Merge entries that share the same value (bounds complexity)."""
        by_val: dict[int, tuple[object, list[Box]]] = {}
        order: list[int] = []
        for r, v in self.entries:
            k = (id(v) if not isinstance(v, (int, str, tuple, frozenset))
                 else hash((type(v).__name__, v)))
            if k in by_val:
                by_val[k][1].extend(r.boxes)
            else:
                by_val[k] = (v, list(r.boxes))
                order.append(k)
        self._set_entries(
            [(Region.from_disjoint(_merge_adjacent(boxes)), v)
             for k in order for v, boxes in [by_val[k]]])

    def __len__(self) -> int:
        return len(self.entries)


def split_box(box: Box, num_chunks: int, dims: Sequence[int] = (0,),
              granularity: Sequence[int] | None = None) -> list[Box]:
    """Split ``box`` into at most ``num_chunks`` boxes along ``dims``.

    This is Celerity's static work-assignment split: chunks are as even as
    possible, aligned to ``granularity`` in each split dimension, and empty
    chunks are dropped (small index spaces yield fewer chunks than requested).
    Multi-dim splits factor ``num_chunks`` greedily over ``dims``.
    """
    if num_chunks <= 1 or box.empty():
        return [box] if not box.empty() else []
    if len(dims) == 1:
        d = dims[0]
        extent = box.max[d] - box.min[d]
        gran = (granularity[0] if granularity else 1) or 1
        units = (extent + gran - 1) // gran
        n = min(num_chunks, units)
        out = []
        base, rem = divmod(units, n)
        cursor = box.min[d]
        for i in range(n):
            take = (base + (1 if i < rem else 0)) * gran
            lo, hi = list(box.min), list(box.max)
            lo[d] = cursor
            hi[d] = min(cursor + take, box.max[d])
            cursor = hi[d]
            b = Box(tuple(lo), tuple(hi))
            if not b.empty():
                out.append(b)
        return out
    # 2-D split: factor num_chunks as close to square as possible
    d0, d1 = dims[0], dims[1]
    best = (num_chunks, 1)
    for f in range(1, int(num_chunks ** 0.5) + 1):
        if num_chunks % f == 0:
            best = (num_chunks // f, f)
    rows = split_box(box, best[0], (d0,), granularity)
    out = []
    for r in rows:
        out.extend(split_box(r, best[1], (d1,),
                             (granularity[1:] if granularity and len(granularity) > 1 else None)))
    return out
