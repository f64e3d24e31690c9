"""The torch port's reductions held against ``repro.core``.

The runtime cases of ``tests/test_reduction.py`` and ``tests/test_allreduce.py``
run the same program on both runtimes on the CPU (``device="cpu"``): the
values must equal ``math.fsum`` (or the exact answer) and the reference's
bit for bit, and since the graph modules are copies, the instruction counts,
allocation counts, ``comm_stats()`` and live bytes must be equal too.  Both
runtimes use ``retransmit_timeout=60.0`` so no spurious retransmit can make
their counters differ.
"""

import math

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.collective import allreduce_message_count
from repro_torch.core import ExecutionAborted, ReductionView
from repro_torch.core.allocation import PINNED_HOST, Allocation
from repro_torch.core.communicator import Communicator, Payload, ReceiveArbiter
from repro_torch.core.instruction_graph import (CollFragment, Instruction,
                                                InstructionType, Pilot)
from repro_torch.core.reduction import _make_op
from torch_parity import keep_reference_ids  # noqa: F401

QUIET = dict(retransmit_timeout=60.0)


def _structure(rt):
    return dict(instructions=rt.total_instructions(),
                allocs=rt.total_allocs(), comm=rt.comm_stats(),
                live=[r["real_used"] for r in rt.memory_report()])


def _run(api, nodes, devices, program, **kw):
    """``program(rt, api)`` on one package's runtime; its result and the
    run's structure."""
    extra = {"device": "cpu"} if api is port_core else {}
    with api.Runtime(nodes, devices, **QUIET, **kw, **extra) as rt:
        out = program(rt, api)
        structure = _structure(rt)
        assert rt.warnings == [], rt.warnings
    return out, structure


def _both(nodes, devices, program, **kw):
    """Run ``program`` on both runtimes; assert equal structure; return the
    port's result and the reference's."""
    exp, ref_s = _run(ref_core, nodes, devices, program, **kw)
    got, port_s = _run(port_core, nodes, devices, program, **kw)
    assert port_s == ref_s
    return got, exp


def _contribute(chunk, xv, red):
    red.contribute(xv.get(chunk))


def _reduce(data, op="sum", identity=None, dtype=None, init=0.0,
            include_current=False):
    """A program reducing ``data`` with ``op`` into a one-element buffer."""
    dtype = dtype or data.dtype
    n = data.shape[0]

    def program(rt, api):
        X = rt.buffer(data.shape, dtype=data.dtype, init=data, name="X")
        R = rt.buffer((1,), dtype=dtype, init=np.full(1, init, dtype),
                      name="R")
        rt.submit("k", (n,), [api.read(X, api.one_to_one()),
                              api.reduction(R, op, identity,
                                            include_current_value=include_current)],
                  _contribute)
        return rt.gather(R)[0]
    return program


def _mixed(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, size=n)


# -- exact sum ------------------------------------------------------------------------
@pytest.mark.parametrize("nodes,devices", [(1, 1), (2, 2), (4, 1), (3, 1),
                                           (3, 2)])
def test_exact_sum_any_split(nodes, devices):
    data = _mixed(257, 0)
    got, exp = _both(nodes, devices, _reduce(data))
    assert got == exp == math.fsum(data)


def test_exact_sum_1e5_elements():
    data = _mixed(100_000, 5)
    got, exp = _both(2, 2, _reduce(data))
    assert got == exp == math.fsum(data)


def test_integer_sum_is_exact_beyond_2_53():
    data = np.array([2 ** 53 + 1, 1, -7, 2 ** 60], dtype=np.int64)
    got, exp = _both(2, 2, _reduce(data))
    assert int(got) == int(exp) == 2 ** 53 + 1 + 1 - 7 + 2 ** 60


def test_exact_sum_rejects_non_finite():
    data = np.array([1.0, np.inf, 2.0, 3.0])
    with port_core.Runtime(1, 1, device="cpu") as rt:
        X = rt.buffer((4,), init=data, name="X")
        R = rt.buffer((1,), init=np.zeros(1), name="R")
        rt.submit("k", (4,), [port_core.read(X, port_core.one_to_one()),
                              port_core.reduction(R, "sum")], _contribute)
        with pytest.raises(ExecutionAborted) as err:
            rt.sync(timeout=20)
    errs = [e for _, e in err.value.failures]
    assert any(isinstance(e, ValueError) and "non-finite" in str(e)
               for e in errs)


@pytest.mark.parametrize("nodes", [1, 2, 4])
def test_include_current_value_folds_once(nodes):
    data = np.arange(32.0)
    got, exp = _both(nodes, 1, _reduce(data, init=5.5, include_current=True))
    assert got == exp == math.fsum(list(data) + [5.5])


# -- other operators ------------------------------------------------------------------
def _hypot(a, b):
    return np.hypot(a, b)


@pytest.mark.parametrize("op,identity", [("max", None), ("min", None),
                                         ("prod", None), (_hypot, 0.0)])
def test_minmax_prod_and_custom_ops(op, identity):
    data = np.array([3.0, -7.5, 2.25, 11.0, 0.5, -1.25, 4.0, 1.5])
    got, exp = _both(2, 2, _reduce(data, op, identity, init=1.0))
    assert got == exp
    want = {"max": 11.0, "min": -7.5, "prod": np.prod(data),
            _hypot: np.sqrt((data ** 2).sum())}[op]
    # prod and hypot fold in canonical node order, not numpy's
    assert got == pytest.approx(want, rel=1e-15)


@pytest.mark.parametrize("op,want", [("max", 26), ("min", -5)])
def test_integer_minmax_reduction(op, want):
    data = np.arange(32, dtype=np.int64) - 5
    got, exp = _both(2, 2, _reduce(data, op))
    assert int(got) == int(exp) == want


# -- allreduce (DESIGN.md §9) ----------------------------------------------------------
def _two_reductions(rt, api, n=193):
    rng = np.random.default_rng(23)
    data = rng.normal(size=n) * 10.0 ** rng.integers(-18, 18, size=n)
    vdata = rng.normal(size=(n, 3))
    X = rt.buffer((n,), init=data, name="X")
    E = rt.buffer((1,), init=np.zeros(1), name="E")
    Y = rt.buffer((n, 3), init=vdata, name="Y")
    W = rt.buffer((3,), init=np.zeros(3), name="W")

    def kw(chunk, yv, red):
        red.contribute(yv.get(api.Box((chunk.min[0], 0), (chunk.max[0], 3))))

    rt.submit("e", (n,), [api.read(X, api.one_to_one()),
                          api.reduction(E, "sum")], _contribute)
    rt.submit("w", (n, 3), [api.read(Y, api.one_to_one()),
                            api.reduction(W, "sum")], kw)
    return (float(rt.gather(E)[0]), list(rt.gather(W)), data, vdata,
            rt.comm_stats())


@pytest.mark.parametrize("nodes", [1, 2, 3, 4, 6])
def test_allreduce_bitexact_vs_fsum_and_fallback(nodes):
    """Scalar and vector sums: the allreduce result equals ``math.fsum``, the
    slot-allgather fallback and the reference on every grid."""
    (e_a, w_a, data, vdata, st_a), exp_a = _both(
        nodes, 1, _two_reductions, reduction_allreduce=True, host_threads=2)
    (e_f, w_f, _, _, st_f), exp_f = _both(
        nodes, 1, _two_reductions, reduction_allreduce=False, host_threads=2)
    assert e_a == e_f == exp_a[0] == exp_f[0] == math.fsum(data)
    fsums = [math.fsum(vdata[:, j]) for j in range(3)]
    assert w_a == w_f == exp_a[1] == exp_f[1] == fsums
    if nodes >= 4:
        assert 0 < st_a["red_bytes"] <= 0.6 * st_f["red_bytes"]


@pytest.mark.parametrize("nodes,devices", [(2, 2), (3, 2)])
def test_allreduce_multi_device(nodes, devices):
    (e, w, data, vdata, _), exp = _both(nodes, devices, _two_reductions,
                                        host_threads=2)
    assert e == exp[0] == math.fsum(data)
    assert w == exp[1] == [math.fsum(vdata[:, j]) for j in range(3)]


@pytest.mark.parametrize("nodes", [2, 3, 4, 6])
def test_allreduce_fusion_interop(nodes):
    """Adjacent E and M reductions share one exchange: the reduction message
    count is the replicated schedule's."""
    n = 96
    data = np.random.default_rng(7).normal(size=n)

    def program(rt, api):
        X = rt.buffer((n,), init=data, name="X")
        E = rt.buffer((1,), init=np.zeros(1), name="E")
        M = rt.buffer((1,), init=np.zeros(1), name="M")
        rt.submit("e", (n,), [api.read(X, api.one_to_one()),
                              api.reduction(E, "sum")],
                  lambda chunk, xv, red: red.contribute(xv.get(chunk) ** 2))
        rt.submit("m", (n,), [api.read(X, api.one_to_one()),
                              api.reduction(M, "sum")],
                  lambda chunk, xv, red: red.contribute(xv.get(chunk) * 3.0))
        return (float(rt.gather(E)[0]), float(rt.gather(M)[0]),
                rt.comm_stats()["red_messages"])

    (e, m, msgs), exp = _both(nodes, 1, program, host_threads=2)
    assert (e, m) == exp[:2] == (math.fsum(data ** 2), math.fsum(data * 3.0))
    group = tuple(range(nodes))
    assert msgs == allreduce_message_count(group, group, 1)


@pytest.mark.parametrize("nodes", [2, 3, 4, 6])
def test_allreduce_subset_participants(nodes):
    """Only node 0 contributes; every node ends with the replicated value."""
    def program(rt, api):
        X = rt.buffer((8,), init=np.arange(8.0), name="X")
        E = rt.buffer((1,), init=np.zeros(1), name="E")
        O = rt.buffer((nodes,), init=np.zeros(nodes), name="O")

        def k(chunk, xv, red):
            red.contribute(xv.get(api.Box((0,), (8,))))

        def use(chunk, ev, ov):
            ov.set(chunk, ov.get(chunk) + ev.get(api.Box((0,), (1,)))[0])

        rt.submit("red", api.Box((0,), (1,)),
                  [api.read(X, api.fixed(api.Box((0,), (8,)))),
                   api.reduction(E, "sum")], k)
        rt.submit("use", (nodes,), [api.read(E, api.all_range()),
                                    api.read_write(O, api.one_to_one())], use)
        return list(rt.gather(O))

    got, exp = _both(nodes, 1, program, host_threads=2)
    assert got == exp == [math.fsum(np.arange(8.0))] * nodes


@pytest.mark.parametrize("nodes", [2, 3, 4])
def test_prod_matches_p2p_oracle(nodes):
    """prod folds in canonical node order: the collective exchange equals the
    point-to-point one (whose partials land through GATHER_RECEIVE)."""
    data = 1.0 + np.arange(12.0) / 7
    vals = [_both(nodes, 1, _reduce(data, "prod", init=1.0), collectives=coll,
                  host_threads=2) for coll in (False, True)]
    assert vals[0][0] == vals[1][0] == vals[0][1] == vals[1][1]


@pytest.mark.parametrize("nodes", [2, 4, 6])
@pytest.mark.parametrize("op", ["max", "min"])
def test_order_free_minmax_allreduce(nodes, op):
    data = np.random.default_rng(31).normal(size=57)
    got, exp = _both(nodes, 1, _reduce(data, op), host_threads=2)
    assert got == exp == (data.max() if op == "max" else data.min())


@pytest.mark.parametrize("nodes", [2, 3])
def test_point_to_point_sum(nodes):
    """``collectives=False``: node partials go by SEND and GATHER_RECEIVE."""
    data = _mixed(64, 9)
    got, exp = _both(nodes, 2, _reduce(data), collectives=False)
    assert got == exp == math.fsum(data)


# -- pieces ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,values", [
    (torch.float32, [0.1, 1e30, -1e30, 3.0]),
    (torch.float64, [0.1, 1e300, -1e300, 3.0]),
    (torch.bfloat16, [0.1, 1e30, -1e30, 3.0]),
    (torch.int64, [2 ** 53 + 1, 1, 2 ** 62, -5])])
def test_view_contributes_tensors_exactly(dtype, values):
    """bf16 widens to f32 exactly; int64 stays integer (exact above 2^53)."""
    t = torch.tensor(values, dtype=dtype)
    acc_view = ReductionView(_make_op("sum", None).identity_acc(
        (1,), np.dtype(np.float64)), _make_op("sum", None))
    acc_view.contribute(t)
    got = acc_view.op.finalize(acc_view.acc, np.dtype(
        np.int64 if dtype == torch.int64 else np.float64))[0]
    if dtype == torch.int64:
        assert int(got) == sum(values)
    else:
        assert got == math.fsum(t.double().tolist())


def test_scratch_bytes_count_as_the_reference():
    """A reduction scratch is a host array whatever its memory id, and its
    ALLOC and FREE count ``ndarray.nbytes`` (8 bytes a slot for the exact
    sum's object array), as the reference's executor does."""
    with port_core.Runtime(1, 1, device="cpu") as rt:
        ex = rt.executors[0]
        for dtype in (object, np.float32):
            a = Allocation(mid=2, bid=None, box=port_core.Box((0, 0), (3, 5)),
                           dtype=dtype)
            before = ex.mem_used.get(2, 0)
            ex._exec_alloc(Instruction(InstructionType.ALLOC, node=0,
                                       allocation=a))
            arr = ex.store[a.aid]
            assert isinstance(arr, np.ndarray) and arr.dtype == np.dtype(dtype)
            assert ex.mem_used[2] - before == arr.nbytes == a.nbytes()
            ex._exec_free(Instruction(InstructionType.FREE, node=0,
                                      allocation=a))
            assert ex.mem_used[2] == before and a.aid not in ex.store


def test_arbiter_lands_numpy_slot_ranges_with_late_pilots():
    """A COLL_RECV with a slot-range landing map over host (numpy) reduction
    scratches: fragments land at their flat ranges, completion needs every
    expected key, late pilots change nothing."""
    comm = Communicator(2)
    store = {}
    acc = Allocation(mid=PINNED_HOST, bid=None, box=port_core.Box((0,), (8,)),
                     dtype=object)
    scr = Allocation(mid=PINNED_HOST, bid=None, box=port_core.Box((0,), (4,)),
                     dtype=object)
    store[acc.aid] = np.full(8, -1, dtype=object)
    store[scr.aid] = np.full(4, -1, dtype=object)
    arb = ReceiveArbiter(0, comm, store)
    tid = (5, 0, 3, 1)
    land = [CollFragment(key=(0, 4, 8), alloc=acc, srange=(4, 8)),
            CollFragment(key=(1, 0, 4), alloc=scr, srange=(0, 4))]
    rc = Instruction(InstructionType.COLL_RECV, node=0, transfer_id=tid,
                     coll_source=1, coll_allocs=(acc, scr),
                     coll_expect=tuple(f.key for f in land),
                     coll_land=tuple(land))
    rc.state = "issued"
    arb.begin(rc)
    done = []
    big = np.array([1 << 2000, 2, 3, 4], dtype=object)
    comm.isend(0, Payload(source=1, msg_id=0, transfer_id=tid,
                          fragments=[((0, 4, 8), big)]))
    arb.step(done)
    assert done == [] and list(store[acc.aid]) == [-1] * 4 + list(big)
    comm.post_pilot(Pilot(source=1, target=0, transfer_id=tid,
                          box=port_core.Box((0,), (8,)), msg_id=1,
                          gather=True))
    arb.step(done)
    assert done == []
    comm.isend(0, Payload(source=1, msg_id=1, transfer_id=tid,
                          fragments=[((1, 0, 4), np.full(4, 7, dtype=object))]))
    arb.step(done)
    assert done == [rc] and list(store[scr.aid]) == [7] * 4
    assert not arb.has_pending()
    # the wire counted each object slot as 8 bytes, as ndarray.nbytes does
    assert comm.bytes_sent == 8 * 8
