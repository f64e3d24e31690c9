# Copied from src/repro/core/collective.py.
"""Collective exchange topologies (DESIGN.md §9).

Pure, replicated-deterministic schedule functions shared by the CDAG
(collective detection + dependency wiring) and the IDAG (lowering into
per-round ``COLL_SEND`` / ``COLL_RECV`` instructions).  A schedule is a
list of *rounds*; each round is a list of :class:`CollMsg` — one point-to-
point message carrying a set of *blocks* (identified by absolute rank).

* **Allgather** uses the dissemination (Bruck-style) generalization of
  recursive doubling: at round ``k`` every rank receives from the rank
  ``2^k`` below it (mod P) everything that peer holds and it does not.
  Works for ANY group size in ``ceil(log2 P)`` rounds with at most one
  message per rank per round — total message count ``<= P * ceil(log2 P)``
  versus ``P * (P - 1)`` for the all-pairs exchange.  Ranks without an own
  contribution (e.g. non-participant nodes of a reduction) simply start
  with an empty held set and forward what they receive.
* **Broadcast / scatter** use a binomial tree rooted at the data owner:
  ``ceil(log2 P)`` rounds, ``P - 1`` messages total, the root sends only
  ``ceil(log2 P)`` of them.  Scatter messages carry exactly the blocks of
  the receiver's subtree, so payloads halve per hop.
* **Reduce-scatter** (the first phase of the allreduce, DESIGN.md §9)
  uses recursive halving: each round a rank folds the incoming slot-range
  fragment into the half of its accumulator it keeps and sends the other
  half, so after ``log2 m`` rounds each of the ``m`` active ranks owns one
  fully folded shard of the slot space.  Non-power-of-two groups use the
  standard pre-fold: the ``P - m`` excess ranks ship their whole partial
  to a neighbour and drop out of the halving.  The schedule works in
  *shard index* space (``m`` shards), so fused reduction members of
  different sizes share one message structure and map shard ranges to
  their own slot ranges via :func:`shard_bounds`.

Every round is independently schedulable: a round-``k`` send depends only
on the previous rounds' receives of the blocks it forwards, so rounds of
different collectives interleave freely in the out-of-order executor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class CollMsg:
    """One message of one round: ``src`` sends ``blocks`` to ``dst``.

    Ranks are absolute node ids; block ids are absolute ranks too (the
    contributor whose piece/partial the block carries).
    """

    src: int
    dst: int
    blocks: tuple[int, ...]


def num_rounds(p: int) -> int:
    """``ceil(log2 p)`` — rounds needed to span a group of ``p`` ranks."""
    r = 0
    while (1 << r) < p:
        r += 1
    return r


def allgather_schedule(group: Sequence[int],
                       contributors: Sequence[int]) -> list[list[CollMsg]]:
    """Dissemination allgather over ``group``; any size, any contributor set.

    After round ``k`` rank ``j`` holds the initial blocks of ranks
    ``j, j-1, ..., j-(2^(k+1)-1)`` (mod P), so ``ceil(log2 P)`` rounds
    deliver every contribution everywhere.  Messages whose block set would
    be empty are skipped, keeping the total ``<= P * ceil(log2 P)``.
    """
    ranks = list(group)
    p = len(ranks)
    pos = {r: i for i, r in enumerate(ranks)}
    held: list[set[int]] = [set() for _ in range(p)]
    for c in contributors:
        held[pos[c]].add(c)
    rounds: list[list[CollMsg]] = []
    for k in range(num_rounds(p)):
        d = 1 << k
        snapshot = [set(h) for h in held]
        msgs: list[CollMsg] = []
        for j in range(p):
            i = (j - d) % p               # j receives from i
            blocks = snapshot[i] - snapshot[j]
            if blocks:
                msgs.append(CollMsg(ranks[i], ranks[j], tuple(sorted(blocks))))
                held[j] |= blocks
        rounds.append(msgs)
    return rounds


def tree_schedule(group: Sequence[int], root: int, *,
                  scatter: bool = False) -> list[list[CollMsg]]:
    """Binomial-tree broadcast (or scatter) rounds rooted at ``root``.

    Relative rank 0 is the root; at the round with distance ``d`` every
    holder ``r`` (``r % 2d == 0``) sends to ``r + d``.  For a broadcast the
    payload is always the root's full block; for a scatter the message
    carries exactly the blocks of the receiver's subtree
    (relative ranks ``[r+d, r+2d)``), so no rank ever receives data it
    neither consumes nor forwards.
    """
    rel = [root] + sorted(x for x in group if x != root)
    p = len(rel)
    rounds: list[list[CollMsg]] = []
    for k in reversed(range(num_rounds(p))):
        d = 1 << k
        msgs: list[CollMsg] = []
        for r in range(0, p, 2 * d):
            if r + d < p:
                blocks = (tuple(rel[r + d:min(r + 2 * d, p)]) if scatter
                          else (root,))
                msgs.append(CollMsg(rel[r], rel[r + d], blocks))
        rounds.append(msgs)
    return rounds


@dataclass(frozen=True)
class RsMsg:
    """One reduce-scatter message: ``src`` sends the partial sums of the
    shard index range ``shards = (lo, hi)`` to ``dst``, which folds them
    into its own accumulator (fold-on-receive)."""

    src: int
    dst: int
    shards: tuple[int, int]


def shard_bounds(num_slots: int, num_shards: int) -> list[int]:
    """Slot-space boundaries of an even partition into ``num_shards``.

    ``bounds[s] = s * num_slots // num_shards``; shard ``s`` covers slots
    ``[bounds[s], bounds[s+1])``.  Degenerate shards (fewer slots than
    shards) are empty ranges — their messages are simply skipped, which
    every rank derives identically from the replicated schedule.
    """
    return [s * num_slots // num_shards for s in range(num_shards + 1)]


def reduce_scatter_schedule(
        group: Sequence[int]) -> tuple[list[list[RsMsg]], dict[int, int], int]:
    """Recursive-halving reduce-scatter over ``group``, in shard space.

    Returns ``(rounds, owner, m)`` where ``m`` is the largest power of two
    ``<= len(group)``, ``owner`` maps each of the ``m`` *active* ranks to
    the single shard index it ends up owning fully folded, and ``rounds``
    is the message schedule:

    * **pre-fold round** (non-power-of-two only): rank ``2i+1`` of the
      first ``2(P - m)`` ranks sends its whole partial (all ``m`` shards)
      to rank ``2i`` and drops out of the halving;
    * **halving rounds**: at distance ``d = m/2, m/4, ..., 1`` active
      ranks pair up (``i`` with ``i ^ d`` in active-index space); the pair
      holds an identical shard range, the lower index keeps the lower
      half and receives+folds it, the upper index keeps the upper half.

    Each active rank sends and receives at most one message per round, so
    fold-on-receive is a simple per-rank chain.  Total slot traffic is
    ``~(P-1)/P`` of the slot space per rank versus the full slot space
    ``P-1`` times over for the full-partial allgather — combined with the
    shard allgather the allreduce ships ``~2/P`` of the bytes.
    """
    ranks = list(group)
    p = len(ranks)
    m = 1
    while m * 2 <= p:
        m *= 2
    r = p - m
    rounds: list[list[RsMsg]] = []
    if r:
        rounds.append([RsMsg(src=ranks[2 * i + 1], dst=ranks[2 * i],
                             shards=(0, m)) for i in range(r)])
    active = [ranks[2 * i] for i in range(r)] + ranks[2 * r:]
    span: list[tuple[int, int]] = [(0, m)] * m
    d = m // 2
    while d >= 1:
        msgs: list[RsMsg] = []
        for i in range(m):
            j = i ^ d
            if j < i:
                continue
            lo, hi = span[i]                  # == span[j] by construction
            mid = (lo + hi) // 2
            # i (bit clear) keeps the lower half, j the upper half
            msgs.append(RsMsg(active[i], active[j], (mid, hi)))
            msgs.append(RsMsg(active[j], active[i], (lo, mid)))
            span[i] = (lo, mid)
            span[j] = (mid, hi)
        rounds.append(msgs)
        d //= 2
    owner = {active[i]: span[i][0] for i in range(m)}
    return rounds, owner, m


def allreduce_message_count(participants: Sequence[int],
                            group: Sequence[int], num_slots: int) -> int:
    """Wire messages of one reduction exchange under the default policy
    (used by tests/examples as the oracle): the reduce-scatter + shard
    allgather at >= 3 nodes, the full-partial slot allgather below (where
    the decomposition cannot reduce bytes — see CommandGraphGenerator).

    ``num_slots`` models ONE member size; for fused groups it is exact
    only when every member has that size (a message is skipped only when
    EVERY member's slot range is empty, so mixed-size groups ship the
    union of the per-member message sets and this count is a floor).
    """
    if len(group) < 3:
        return message_count(allgather_schedule(group, participants))
    rs_rounds, owner, m = reduce_scatter_schedule(participants)
    bounds = shard_bounds(num_slots, m)
    n = sum(1 for msgs in rs_rounds for msg in msgs
            if bounds[msg.shards[0]] < bounds[msg.shards[1]])
    contributors = tuple(sorted(a for a, s in owner.items()
                                if bounds[s] < bounds[s + 1]))
    n += message_count(allgather_schedule(group, contributors))
    return n


def schedule_for(kind: str, group: Sequence[int], *,
                 contributors: Sequence[int] = (),
                 root: int | None = None) -> list[list[CollMsg]]:
    """Uniform entry point used by CDAG and IDAG (must agree bit-for-bit)."""
    if kind == "allgather":
        return allgather_schedule(group, contributors)
    if kind == "broadcast":
        return tree_schedule(group, root, scatter=False)
    if kind == "scatter":
        return tree_schedule(group, root, scatter=True)
    raise ValueError(f"unknown collective kind {kind!r}")


def message_count(rounds: list[list[CollMsg]]) -> int:
    return sum(len(msgs) for msgs in rounds)
