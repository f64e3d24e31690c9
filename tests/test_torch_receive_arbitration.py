"""The cases of ``tests/test_receive_arbitration.py`` on the torch port's
communicator and receive arbiter (``core/communicator.py``), on the CPU.

Paper §3.4's three inbound geometries: an await-push only knows the UNION of
regions that will arrive, and the sender geometry becomes known at
execution time through pilots and payloads.  The arbiter completes a
split-receive's await-receive children when (a) senders transmit the
consumer split, (b) one sender covers the whole region, (c) senders
transmit a geometry orthogonal to the consumer split; and it buffers early
payloads, suppresses duplicates and rejects stale or misaddressed traffic.

Each case is a function of a package's ``core`` modules.  It runs on the
port; where it reads a count (suppressed duplicates, acks, stale
rejections), it runs on the JAX package too and the counts must be equal.
"""

import importlib
from types import SimpleNamespace

import numpy as np

import repro.core as ref_core
import repro_torch.core as port_core
from torch_parity import keep_reference_ids  # noqa: F401


def _api(core):
    """The names these cases use, from ``core``'s modules."""
    base = core.__name__
    alloc = importlib.import_module(f"{base}.allocation")
    comm = importlib.import_module(f"{base}.communicator")
    ig = importlib.import_module(f"{base}.instruction_graph")
    return SimpleNamespace(
        Box=core.Box, Region=core.Region, Allocation=alloc.Allocation,
        PINNED_HOST=alloc.PINNED_HOST, Communicator=comm.Communicator,
        Payload=comm.Payload, ReceiveArbiter=comm.ReceiveArbiter,
        Instruction=ig.Instruction, InstructionType=ig.InstructionType,
        Pilot=ig.Pilot, CollFragment=ig.CollFragment)


PORT, REF = _api(port_core), _api(ref_core)


def make_split_receive(a, alloc, tid, union_box, consumer_boxes):
    split = a.Instruction(a.InstructionType.SPLIT_RECEIVE, node=0,
                          transfer_id=tid,
                          recv_region=a.Region.from_box(union_box),
                          recv_alloc=alloc)
    awaits = []
    for cb in consumer_boxes:
        aw = a.Instruction(a.InstructionType.AWAIT_RECEIVE, node=0,
                           transfer_id=tid, recv_region=a.Region.from_box(cb),
                           recv_alloc=alloc, split_parent=split)
        awaits.append(aw)
    return split, awaits


def setup(a, union_box):
    comm = a.Communicator(2)
    store = {}
    alloc = a.Allocation(mid=a.PINNED_HOST, bid=0, box=union_box)
    store[alloc.aid] = np.full(union_box.shape, -1.0)
    arb = a.ReceiveArbiter(0, comm, store)
    return comm, store, alloc, arb


def drain(arb):
    done = []
    arb.step(done)
    return done


def _case_a_matching_geometry(a):
    """Two senders transmit exactly the two consumer halves; each await
    completes as soon as ITS half lands (early compute start)."""
    union = a.Box((0,), (8,))
    comm, store, alloc, arb = setup(a, union)
    tid = (1, 0)
    split, (aw0, aw1) = make_split_receive(
        a, alloc, tid, union, [a.Box((0,), (4,)), a.Box((4,), (8,))])
    for i in (split, aw0, aw1):
        i.state = "issued"
        arb.begin(i)
    # first half lands -> only aw0 completes
    comm.isend(0, a.Payload(1, 0, tid, a.Box((0,), (4,)), np.arange(4.0)))
    done = drain(arb)
    assert aw0 in done and aw1 not in done
    np.testing.assert_array_equal(store[alloc.aid][:4], np.arange(4.0))
    # second half -> split + aw1 complete
    comm.isend(0, a.Payload(1, 1, tid, a.Box((4,), (8,)), np.arange(4.0) + 10))
    done = drain(arb)
    assert aw1 in done and split in done


def _case_b_single_sender_whole_region(a):
    """One payload covers the union: all awaits complete together."""
    union = a.Box((0,), (8,))
    comm, store, alloc, arb = setup(a, union)
    tid = (2, 0)
    split, (aw0, aw1) = make_split_receive(
        a, alloc, tid, union, [a.Box((0,), (4,)), a.Box((4,), (8,))])
    for i in (split, aw0, aw1):
        i.state = "issued"
        arb.begin(i)
    comm.isend(0, a.Payload(1, 0, tid, union, np.arange(8.0)))
    done = drain(arb)
    assert {aw0, aw1, split} <= set(done)
    np.testing.assert_array_equal(store[alloc.aid], np.arange(8.0))


def _case_c_orthogonal_geometry(a):
    """2-D: consumers split by rows, senders split by columns.  Each await
    completes only once BOTH column payloads covering its rows landed."""
    union = a.Box((0, 0), (4, 4))
    comm, store, alloc, arb = setup(a, union)
    tid = (3, 0)
    split, (aw_top, aw_bot) = make_split_receive(
        a, alloc, tid, union, [a.Box((0, 0), (2, 4)), a.Box((2, 0), (4, 4))])
    for i in (split, aw_top, aw_bot):
        i.state = "issued"
        arb.begin(i)
    # left column block arrives: covers rows 0..4 x cols 0..2 — neither
    # row-consumer is fully covered yet
    left = np.ones((4, 2))
    comm.isend(0, a.Payload(1, 0, tid, a.Box((0, 0), (4, 2)), left))
    done = drain(arb)
    assert aw_top not in done and aw_bot not in done
    # right column block arrives: both awaits now covered
    right = np.full((4, 2), 2.0)
    comm.isend(0, a.Payload(1, 1, tid, a.Box((0, 2), (4, 4)), right))
    done = drain(arb)
    assert aw_top in done and aw_bot in done and split in done
    np.testing.assert_array_equal(store[alloc.aid][:, :2], left)
    np.testing.assert_array_equal(store[alloc.aid][:, 2:], right)


def _case_payload_before_receive_posted(a):
    """Eager senders: the payload arrives BEFORE the receive instruction is
    issued (buffered as 'early', landed on begin)."""
    union = a.Box((0,), (4,))
    comm, store, alloc, arb = setup(a, union)
    tid = (4, 0)
    comm.isend(0, a.Payload(1, 0, tid, union, np.arange(4.0)))
    drain(arb)                       # nothing pending yet
    recv = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=tid,
                         recv_region=a.Region.from_box(union),
                         recv_alloc=alloc)
    recv.state = "issued"
    arb.begin(recv)
    done = drain(arb)
    assert recv in done
    np.testing.assert_array_equal(store[alloc.aid], np.arange(4.0))


def _case_multi_fragment_with_pilots_after_split(a):
    """Pilots and payloads arrive AFTER the receive was already split into
    await-receives, in multiple fragments per consumer half; each await
    completes exactly when its half is fully covered."""
    union = a.Box((0,), (8,))
    comm, store, alloc, arb = setup(a, union)
    tid = (7, 0)
    split, (aw0, aw1) = make_split_receive(
        a, alloc, tid, union, [a.Box((0,), (4,)), a.Box((4,), (8,))])
    for i in (split, aw0, aw1):
        i.state = "issued"
        arb.begin(i)
    assert drain(arb) == []                   # nothing in flight yet
    # pilots announce four fragments only AFTER the split was posted
    frags = [a.Box((0,), (2,)), a.Box((2,), (4,)), a.Box((4,), (6,)),
             a.Box((6,), (8,))]
    for m, b in enumerate(frags):
        comm.post_pilot(a.Pilot(source=1, target=0, transfer_id=tid, box=b,
                                msg_id=m))
    assert drain(arb) == []                   # pilots alone complete nothing
    # fragments land out of order; aw1 completes before aw0
    comm.isend(0, a.Payload(1, 2, tid, frags[2], np.full(2, 3.0)))
    comm.isend(0, a.Payload(1, 3, tid, frags[3], np.full(2, 4.0)))
    done = drain(arb)
    assert aw1 in done and aw0 not in done and split not in done
    comm.isend(0, a.Payload(1, 0, tid, frags[0], np.full(2, 1.0)))
    done = drain(arb)
    assert done == []                         # half of aw0 still missing
    comm.isend(0, a.Payload(1, 1, tid, frags[1], np.full(2, 2.0)))
    done = drain(arb)
    assert aw0 in done and split in done
    np.testing.assert_array_equal(store[alloc.aid],
                                  np.repeat([1.0, 2.0, 3.0, 4.0], 2))
    # once the executor marks the split done, the arbiter drops the entry
    split.state = "done"
    drain(arb)
    assert not arb.has_pending()


def make_gather(a, alloc, tid, box, sources):
    g = a.Instruction(a.InstructionType.GATHER_RECEIVE, node=0,
                      transfer_id=tid,
                      recv_region=a.Region.from_box(box), recv_alloc=alloc,
                      gather_sources=tuple(sources))
    g.state = "issued"
    return g


def _case_gather_receive_lands_by_source_slot(a):
    """Reduction partials from several peers land at slot=source rank of the
    fixed-stride gather staging, regardless of arrival order."""
    comm = a.Communicator(4)
    store = {}
    # slots for ranks 0..3, one partial element each
    galloc = a.Allocation(mid=a.PINNED_HOST, bid=None,
                          box=a.Box((0, 0), (4, 1)))
    store[galloc.aid] = np.full((4, 1), -1.0)
    arb = a.ReceiveArbiter(0, comm, store)
    tid = (9, 0, 1)
    g = make_gather(a, galloc, tid, a.Box((0,), (1,)), sources=[1, 2, 3])
    arb.begin(g)
    assert arb.has_pending()
    # peers arrive out of order; completion only after ALL landed
    comm.isend(0, a.Payload(3, 0, tid, a.Box((0,), (1,)), np.array([30.0])))
    comm.isend(0, a.Payload(1, 1, tid, a.Box((0,), (1,)), np.array([10.0])))
    done = drain(arb)
    assert g not in done
    comm.isend(0, a.Payload(2, 2, tid, a.Box((0,), (1,)), np.array([20.0])))
    done = drain(arb)
    assert g in done
    np.testing.assert_array_equal(store[galloc.aid],
                                  [[-1.0], [10.0], [20.0], [30.0]])
    assert not arb.has_pending()


def _case_gather_payload_before_receive_posted(a):
    """An eager peer's partial arrives before GATHER_RECEIVE is issued; it is
    buffered as early and landed when the gather begins."""
    comm = a.Communicator(2)
    store = {}
    galloc = a.Allocation(mid=a.PINNED_HOST, bid=None,
                          box=a.Box((0, 0), (2, 1)))
    store[galloc.aid] = np.zeros((2, 1))
    arb = a.ReceiveArbiter(0, comm, store)
    tid = (10, 0, 1)
    comm.isend(0, a.Payload(1, 0, tid, a.Box((0,), (1,)), np.array([5.5])))
    drain(arb)                                # buffered, nothing pending
    g = make_gather(a, galloc, tid, a.Box((0,), (1,)), sources=[1])
    arb.begin(g)
    done = drain(arb)
    assert g in done
    assert store[galloc.aid][1, 0] == 5.5


def _case_gather_and_push_traffic_do_not_cross(a):
    """A push payload with the 2-tuple transfer id never lands in a gather
    slot with the 3-tuple reduction id of the same (task, buffer)."""
    comm = a.Communicator(2)
    store = {}
    box = a.Box((0,), (1,))
    galloc = a.Allocation(mid=a.PINNED_HOST, bid=None,
                          box=a.Box((0, 0), (2, 1)))
    palloc = a.Allocation(mid=a.PINNED_HOST, bid=0, box=box)
    store[galloc.aid] = np.zeros((2, 1))
    store[palloc.aid] = np.zeros(1)
    arb = a.ReceiveArbiter(0, comm, store)
    g = make_gather(a, galloc, (11, 0, 1), box, sources=[1])
    recv = a.Instruction(a.InstructionType.RECEIVE, node=0,
                         transfer_id=(11, 0),
                         recv_region=a.Region.from_box(box), recv_alloc=palloc)
    recv.state = "issued"
    arb.begin(g)
    arb.begin(recv)
    comm.isend(0, a.Payload(1, 0, (11, 0), box, np.array([1.0])))
    comm.isend(0, a.Payload(1, 1, (11, 0, 1), box, np.array([2.0])))
    done = drain(arb)
    assert {g, recv} == set(done)
    np.testing.assert_array_equal(store[palloc.aid], [1.0])
    np.testing.assert_array_equal(store[galloc.aid], [[0.0], [2.0]])


def _redeliver(comm, target, payload):
    """Simulate a retransmit race: the sender re-delivers an already-landed
    sequenced copy (same seq) just before the ack reached it."""
    with comm._cv:
        comm.payload_box[target].append(payload)
        comm._cv.notify_all()


def _case_duplicate_push_payload_lands_exactly_once(a):
    """A duplicated sequenced payload is acked twice but landed once —
    re-landing would re-copy stale bytes over a region a later writer may
    already own."""
    union = a.Box((0,), (4,))
    comm, store, alloc, arb = setup(a, union)
    tid = (20, 0)
    recv = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=tid,
                         recv_region=a.Region.from_box(union),
                         recv_alloc=alloc)
    recv.state = "issued"
    arb.begin(recv)
    p = a.Payload(1, 0, tid, union, np.arange(4.0))
    comm.isend(0, p)
    _redeliver(comm, 0, p)
    done = drain(arb)
    assert recv in done
    assert arb.dups_suppressed == 1
    assert comm.acks == 2                    # every delivered copy is acked
    np.testing.assert_array_equal(store[alloc.aid], np.arange(4.0))
    # overwrite the landed region, then a THIRD copy straggles in: suppressed
    store[alloc.aid][:] = 99.0
    _redeliver(comm, 0, p)
    drain(arb)
    assert arb.dups_suppressed == 2
    np.testing.assert_array_equal(store[alloc.aid], np.full(4, 99.0))
    return (arb.dups_suppressed, comm.acks)


def _case_duplicate_coll_fragment_after_scratch_freed(a):
    """A retransmitted collective fragment arrives AFTER the one-shot scratch
    allocation was freed: duplicate suppression must reject it before any
    landing logic touches the (gone) allocation."""
    comm = a.Communicator(2)
    store = {}
    scr = a.Allocation(mid=a.PINNED_HOST, bid=None, box=a.Box((0,), (4,)))
    store[scr.aid] = np.full(4, -1.0)
    arb = a.ReceiveArbiter(0, comm, store)
    tid = (21, 0, 3, 1)
    rc = a.Instruction(a.InstructionType.COLL_RECV, node=0, transfer_id=tid,
                       coll_source=1, coll_allocs=(scr,),
                       coll_expect=((0, 0, 4),),
                       coll_land=(a.CollFragment(key=(0, 0, 4), alloc=scr,
                                               srange=(0, 4)),))
    rc.state = "issued"
    arb.begin(rc)
    p = a.Payload(source=1, msg_id=0, transfer_id=tid,
                  fragments=[((0, 0, 4), np.arange(4.0))])
    comm.isend(0, p)
    done = drain(arb)
    assert rc in done
    del store[scr.aid]                       # executor frees the scratch
    _redeliver(comm, 0, p)
    drain(arb)                               # must not KeyError into store
    assert arb.dups_suppressed == 1
    assert comm.acks == 2
    return (arb.dups_suppressed, comm.acks)


def _case_pilot_arriving_after_payload_is_harmless(a):
    """Eager wires can reorder pilot behind payload; the late pilot only
    feeds stall attribution and never disturbs the landed transfer."""
    union = a.Box((0,), (4,))
    comm, store, alloc, arb = setup(a, union)
    tid = (22, 0)
    recv = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=tid,
                         recv_region=a.Region.from_box(union),
                         recv_alloc=alloc)
    recv.state = "issued"
    arb.begin(recv)
    comm.isend(0, a.Payload(1, 0, tid, union, np.arange(4.0)))
    done = drain(arb)
    assert recv in done
    comm.post_pilot(a.Pilot(source=1, target=0, transfer_id=tid, box=union,
                            msg_id=0))
    assert drain(arb) == []
    np.testing.assert_array_equal(store[alloc.aid], np.arange(4.0))
    # the completed transfer's announcement is garbage-collected with it, so
    # late pilots leave no residual arbiter state behind
    assert not arb.has_pending()
    assert not arb.announced.get(tid)


def _case_stale_tid_traffic_from_aborted_epoch_rejected(a):
    """After ``poison`` (an EPOCH_ABORT), late pilots and payloads for the
    tombstoned transfer are counted and dropped — their allocations belong
    to the dead epoch."""
    union = a.Box((0,), (4,))
    comm, store, alloc, arb = setup(a, union)
    tid = (23, 0)
    recv = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=tid,
                         recv_region=a.Region.from_box(union),
                         recv_alloc=alloc)
    recv.state = "issued"
    arb.begin(recv)
    assert arb.poison("epoch aborted by peer") == 1
    comm.post_pilot(a.Pilot(source=1, target=0, transfer_id=tid, box=union,
                            msg_id=0))
    comm.isend(0, a.Payload(1, 0, tid, union, np.arange(4.0)))
    assert drain(arb) == []
    assert arb.stale_rejected == 1
    assert tid not in arb.announced          # stale pilots not recorded
    assert not arb.has_pending()
    np.testing.assert_array_equal(store[alloc.aid], np.full(4, -1.0))
    assert comm.acks == 1                    # transport-level delivery stands
    return (arb.stale_rejected, comm.acks)


def _case_wrong_source_coll_fragment_never_lands(a):
    """A packed round message from a rank that is NOT the schedule's source
    for this COLL_RECV must not land or complete it (collective rounds are
    source-addressed, unlike push traffic)."""
    comm = a.Communicator(3)
    store = {}
    scr = a.Allocation(mid=a.PINNED_HOST, bid=None, box=a.Box((0,), (4,)))
    store[scr.aid] = np.full(4, -1.0)
    arb = a.ReceiveArbiter(0, comm, store)
    tid = (24, 0, 3, 1)
    rc = a.Instruction(a.InstructionType.COLL_RECV, node=0, transfer_id=tid,
                       coll_source=1, coll_allocs=(scr,),
                       coll_expect=((0, 0, 4),),
                       coll_land=(a.CollFragment(key=(0, 0, 4), alloc=scr,
                                               srange=(0, 4)),))
    rc.state = "issued"
    arb.begin(rc)
    comm.isend(0, a.Payload(source=2, msg_id=0, transfer_id=tid,
                            fragments=[((0, 0, 4), np.full(4, 66.0))]))
    assert drain(arb) == []
    np.testing.assert_array_equal(store[scr.aid], np.full(4, -1.0))
    # the true source arrives: lands and completes
    comm.isend(0, a.Payload(source=1, msg_id=0, transfer_id=tid,
                            fragments=[((0, 0, 4), np.arange(4.0))]))
    done = drain(arb)
    assert rc in done
    np.testing.assert_array_equal(store[scr.aid], np.arange(4.0))


def _case_interleaved_transfers_do_not_cross(a):
    """Two concurrent transfer ids never land into each other's buffers."""
    union = a.Box((0,), (4,))
    comm = a.Communicator(2)
    store = {}
    a1 = a.Allocation(mid=a.PINNED_HOST, bid=0, box=union)
    a2 = a.Allocation(mid=a.PINNED_HOST, bid=1, box=union)
    store[a1.aid] = np.zeros(4)
    store[a2.aid] = np.zeros(4)
    arb = a.ReceiveArbiter(0, comm, store)
    r1 = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=(5, 0),
                       recv_region=a.Region.from_box(union), recv_alloc=a1)
    r2 = a.Instruction(a.InstructionType.RECEIVE, node=0, transfer_id=(6, 1),
                       recv_region=a.Region.from_box(union), recv_alloc=a2)
    for r in (r1, r2):
        r.state = "issued"
        arb.begin(r)
    comm.isend(0, a.Payload(1, 0, (6, 1), union, np.full(4, 2.0)))
    comm.isend(0, a.Payload(1, 1, (5, 0), union, np.full(4, 1.0)))
    done = []
    arb.step(done)
    assert {r1, r2} == set(done)
    np.testing.assert_array_equal(store[a1.aid], np.full(4, 1.0))
    np.testing.assert_array_equal(store[a2.aid], np.full(4, 2.0))


# -- the cases on the port; counted ones against the JAX package's ------------


def test_case_a_matching_geometry():
    _case_a_matching_geometry(PORT)


def test_case_b_single_sender_whole_region():
    _case_b_single_sender_whole_region(PORT)


def test_case_c_orthogonal_geometry():
    _case_c_orthogonal_geometry(PORT)


def test_payload_before_receive_posted():
    _case_payload_before_receive_posted(PORT)


def test_multi_fragment_with_pilots_after_split():
    _case_multi_fragment_with_pilots_after_split(PORT)


def test_gather_receive_lands_by_source_slot():
    _case_gather_receive_lands_by_source_slot(PORT)


def test_gather_payload_before_receive_posted():
    _case_gather_payload_before_receive_posted(PORT)


def test_gather_and_push_traffic_do_not_cross():
    _case_gather_and_push_traffic_do_not_cross(PORT)


def test_duplicate_push_payload_lands_exactly_once():
    assert _case_duplicate_push_payload_lands_exactly_once(PORT) == \
        _case_duplicate_push_payload_lands_exactly_once(REF)


def test_duplicate_coll_fragment_after_scratch_freed():
    assert _case_duplicate_coll_fragment_after_scratch_freed(PORT) == \
        _case_duplicate_coll_fragment_after_scratch_freed(REF)


def test_pilot_arriving_after_payload_is_harmless():
    _case_pilot_arriving_after_payload_is_harmless(PORT)


def test_stale_tid_traffic_from_aborted_epoch_rejected():
    assert _case_stale_tid_traffic_from_aborted_epoch_rejected(PORT) == \
        _case_stale_tid_traffic_from_aborted_epoch_rejected(REF)


def test_wrong_source_coll_fragment_never_lands():
    _case_wrong_source_coll_fragment_never_lands(PORT)


def test_interleaved_transfers_do_not_cross():
    _case_interleaved_transfers_do_not_cross(PORT)
