"""Observability of the torch port: the runtime-driving cases of
``tests/test_observability.py`` and ``tests/test_tracing.py`` on the port's
``Runtime(device="cpu")`` with the same invariants, the same programs on
both runtimes giving records of the same instructions, and the lanes'
launch and sync stamps with the spans derived from them.

On the card a device lane's launch and sync stamps bracket the card's work
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` ``trace``); on the CPU a
lane without a stream stamps both at once.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as jax_core
from repro_torch.core import (Runtime, Tracer, critical_path, one_to_one,
                              read, read_write, reduction)
import repro_torch.core as port_core
from repro_torch.core import backend
from repro_torch.core.instructions import InstructionType
from repro_torch.core.observability import (WAIT_CLASSES, InstrRecord,
                                            lane_utilization)
from torch_parity import keep_reference_ids  # noqa: F401


def _program(rt, core=port_core, steps=6):
    """``_run_traced``'s program of ``tests/test_observability.py``, with the
    accessors of ``core``, the package that ``rt`` belongs to."""
    read, read_write = core.read, core.read_write
    reduction, one_to_one = core.reduction, core.one_to_one
    N = 64
    a = rt.buffer((N, N), init=np.ones((N, N)), name="A")
    b = rt.buffer((N, N), init=np.zeros((N, N)), name="B")
    E = rt.buffer((1,), init=np.zeros(1), name="E")

    def fwd(chunk, av, bv):
        bv.set(chunk, av.get(chunk) * 1.001)

    def bwd(chunk, bv, av):
        av.set(chunk, bv.get(chunk) * 0.999)

    def energy(chunk, av, red):
        red.contribute(av.get(chunk).sum())

    for i in range(steps):
        rt.submit(f"fwd{i}", (N, N),
                  [read(a, one_to_one()), read_write(b, one_to_one())], fwd)
        rt.submit(f"bwd{i}", (N, N),
                  [read(b, one_to_one()), read_write(a, one_to_one())], bwd)
    rt.submit("energy", (N, N),
              [read(a, one_to_one()), reduction(E, "sum")], energy)
    rt.sync()
    return rt


def _run_traced(**kw):
    return _program(Runtime(num_nodes=2, devices_per_node=2, trace=True,
                            device="cpu", **kw))


@pytest.fixture(scope="module")
def traced():
    rt = _run_traced()
    yield rt
    rt.shutdown()


def test_bare_executor_creates_no_timing():
    """A bare executor (no tracer, no metrics) has plain lanes and no
    clock, and so has one with metrics alone; a traced one on the CPU has
    lanes without streams, which stamp on the host and time nothing on a
    card either."""
    for kw in (dict(metrics=False), dict(), dict(trace=True)):
        with Runtime(1, 2, device="cpu", **kw) as rt:
            ex = rt.executors[0]
            assert ex._obs is (kw != dict(metrics=False))
            assert not hasattr(ex.backend, "clock")
            for qs in ex.backend.device_queues:
                for q in qs:
                    assert q.stream is None and not hasattr(q, "clock")
                    assert q._work == (q._run_stamped_host if "trace" in kw
                                       else q._run_host)


# -- records ---------------------------------------------------------------------
def test_records_wait_sum_is_exact(traced):
    recs = traced.tracer.records
    assert recs, "traced run produced no instruction records"
    for r in recs:
        assert r.t_reg <= r.t_ready + 1e-9
        assert r.t_ready <= r.t_start + 1e-9
        assert r.t_start <= r.t_done + 1e-9
        lat = r.t_start - r.t_reg
        parts = (r.t_ready - r.t_reg) + (r.t_start - r.t_ready)
        assert abs(parts - lat) <= 1e-9 + 0.01 * max(lat, 1e-12)
        assert r.wait_cls in WAIT_CLASSES
        if r.t_synced is not None:
            # on the CPU a device lane stamps launch and sync at once
            assert r.t_start <= r.t_launched == r.t_synced <= r.t_done


def test_records_carry_trace_context(traced):
    kernels = [r for r in traced.tracer.records if r.kind == "device_kernel"]
    assert kernels
    for r in kernels:
        assert r.tid is not None and r.cid is not None
    assert {r.node for r in traced.tracer.records} == {0, 1}


def test_records_match_the_reference_runtime(traced):
    """The same program on the JAX package's runtime records the same
    instructions: per node, the same kinds in the same numbers."""
    ref = jax_core.Runtime(num_nodes=2, devices_per_node=2, trace=True)
    try:
        _program(ref, jax_core)

        def census(recs):
            out = {}
            for r in recs:
                out[(r.node, r.kind)] = out.get((r.node, r.kind), 0) + 1
            return out

        assert census(traced.tracer.records) == census(ref.tracer.records)
    finally:
        ref.shutdown()


def test_critical_path_report_is_consistent(traced):
    rep = critical_path(traced.tracer)
    assert rep.total_us > 0
    assert rep.chain_len >= 1
    assert rep.n_instructions == len(traced.tracer.records)
    assert 0.0 <= rep.scheduler_fraction <= 1.0
    accounted = sum(rep.by_layer.values()) + sum(rep.by_wait.values())
    assert accounted <= rep.total_us * (1 + 1e-6)
    assert rep.unattributed_us == pytest.approx(
        rep.total_us - accounted, rel=1e-6, abs=1e-3)
    text = rep.render()
    assert "critical path:" in text
    assert "scheduler share of critical path" in text
    assert rep.as_dict()["total_us"] == rep.total_us
    assert traced.critical_path_report().total_us > 0


def test_utilization_report_reads_record_intervals(traced):
    util = traced.utilization_report()
    assert util == lane_utilization(traced.tracer.records)
    assert util["span_us"] > 0 and util["lanes"]
    for lane in util["lanes"].values():
        assert 0.0 <= lane["busy_frac"] <= 1.0 + 1e-9


def test_critical_path_empty_tracer():
    rep = critical_path(Tracer())
    assert rep.total_us == 0.0 and rep.chain_len == 0


def test_runtime_metrics_snapshot_unified(traced):
    snap = traced.metrics()
    for key in ("counters", "gauges", "histograms", "comm", "memory",
                "lookahead", "executor", "instants"):
        assert key in snap, key
    h = snap["histograms"]
    for n in (0, 1):
        assert h[f"executor.N{n}.issue_us"]["count"] > 0
        for cls in WAIT_CLASSES:
            assert f"executor.N{n}.wait_{cls}_us" in h
    g = snap["gauges"]
    assert "executor.N0.inflight" in g
    assert "lookahead.N0.queued" in g
    assert "sched.N0.horizon_lag" in g
    recs = traced.tracer.records
    for n in (0, 1):
        hist_sum = h[f"executor.N{n}.issue_us"]["sum_us"]
        rec_sum = sum((r.t_start - r.t_reg) * 1e6 for r in recs if r.node == n)
        assert hist_sum == pytest.approx(rec_sum, rel=0.01)
        assert h[f"executor.N{n}.issue_us"]["count"] == \
            sum(1 for r in recs if r.node == n)


def test_runtime_metrics_disabled_still_works():
    rt = Runtime(num_nodes=1, devices_per_node=1, metrics=False, device="cpu")
    try:
        B = rt.buffer((8,), init=np.zeros(8), name="b")
        rt.submit("k", (8,), [read_write(B, one_to_one())],
                  lambda c, v: v.set(c, v.get(c) + 1))
        rt.sync()
        assert rt.metrics_registry is None
        snap = rt.metrics()
        assert snap["counters"] == {} and snap["histograms"] == {}
        assert "memory" in snap and "comm" in snap
        assert rt.executors[0]._obs is False
    finally:
        rt.shutdown()


# -- Perfetto export -------------------------------------------------------------
def _fake_instr(iid):
    return SimpleNamespace(iid=iid, name=f"i{iid}", queue=("device", 0),
                           itype=InstructionType.DEVICE_KERNEL, command=None)


def test_chrome_trace_from_live_runtime(tmp_path):
    with Runtime(num_nodes=2, devices_per_node=1, trace=True,
                 device="cpu") as rt:
        X = rt.buffer((8,), init=np.arange(8.0), name="X")
        E = rt.buffer((1,), init=np.zeros(1), name="E")

        def k(chunk, xv, red):
            red.contribute(xv.get(chunk))

        rt.submit("k", (8,), [read(X, one_to_one()), reduction(E, "sum")], k)
        rt.sync()
        tr = rt.tracer
    out = tmp_path / "live.json"
    tr.to_chrome_trace(out)
    events = json.loads(out.read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e["ph"] == "X"}
    assert {"fill_identity", "local_reduce", "coll_send", "coll_recv",
            "global_reduce"} <= cats
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert any(".coll." in name for name in lanes), lanes


@pytest.fixture(scope="module")
def live_export(tmp_path_factory):
    """``_export_live_trace`` of ``tests/test_tracing.py`` on the port."""
    with Runtime(num_nodes=2, devices_per_node=2, trace=True,
                 device="cpu") as rt:
        X = rt.buffer((64,), init=np.arange(64.0), name="X")
        E = rt.buffer((1,), init=np.zeros(1), name="E")

        def bump(chunk, xv):
            xv.set(chunk, xv.get(chunk) + 1)

        def tally(chunk, xv, red):
            red.contribute(xv.get(chunk).sum())

        for i in range(4):
            rt.submit(f"bump{i}", (64,), [read_write(X, one_to_one())], bump)
        rt.submit("tally", (64,),
                  [read(X, one_to_one()), reduction(E, "sum")], tally)
        rt.sync()
        out = tmp_path_factory.mktemp("trace") / "roundtrip.json"
        rt.tracer.to_chrome_trace(out)
        records = list(rt.tracer.records)
    return json.loads(out.read_text())["traceEvents"], records


def test_export_thread_metadata_covers_every_event(live_export):
    events, _ = live_export
    named = {e["tid"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    used = {e["tid"] for e in events if "tid" in e}
    assert used <= named, f"events on unnamed threads: {used - named}"


def test_export_flow_links_are_well_formed(live_export):
    events, _ = live_export
    starts = {(e["cat"], e["id"]): e["ts"] for e in events if e["ph"] == "s"}
    finishes = [e for e in events if e["ph"] == "f"]
    assert finishes, "no flow arrows exported"
    for e in finishes:
        key = (e["cat"], e["id"])
        assert key in starts, f"flow finish without start: {key}"
        assert starts[key] <= e["ts"] + 1e-6
    ids = {e["id"] for e in finishes}
    assert any(i.startswith("t") for i in ids)
    assert any(i.startswith("i") for i in ids)


def test_export_instruction_flows_complete(live_export):
    events, records = live_export
    flow_ids = {e["id"] for e in events if e["ph"] == "f"}
    linkable = [r for r in records if r.tid is not None]
    assert linkable
    missing = [f"i{r.node}.{r.iid}" for r in linkable
               if f"i{r.node}.{r.iid}" not in flow_ids]
    assert not missing, f"records without flow arrows: {missing[:5]}"


def test_export_wait_spans_balanced(live_export):
    events, records = live_export
    waits = [e for e in events if e.get("cat") == "wait"]
    assert waits, "no wait-state spans exported"
    per_id: dict[str, int] = {}
    for e in waits:
        assert e["ph"] in ("b", "e")
        assert e["name"].startswith("wait:")
        per_id[e["id"]] = per_id.get(e["id"], 0) + (1 if e["ph"] == "b" else -1)
    assert all(v == 0 for v in per_id.values()), "unbalanced b/e pairs"
    rec_ids = {f"w{r.node}.{r.iid}" for r in records}
    assert set(per_id) <= rec_ids


def test_export_counter_tracks_present(live_export):
    events, _ = live_export
    counters = [e for e in events if e["ph"] == "C"]
    assert counters
    for e in counters:
        assert "value" in e["args"]
    names = {e["name"] for e in counters}
    assert any(n.startswith("executor.N") and n.endswith(".inflight")
               for n in names), names


def test_sampled_trace_still_analyzable():
    tr = Tracer(record_sample=3)
    rt = Runtime(1, 2, device="cpu")
    rt.tracer = tr
    for ex in rt.executors:
        ex.tracer = tr
    buf = rt.buffer((16,), init=np.zeros(16))
    for _ in range(6):
        rt.submit("inc", (16,), [read_write(buf, one_to_one())],
                  lambda c, v: v.set(c, v.get(c) + 1))
    out = rt.gather(buf)
    rt.shutdown()
    assert np.array_equal(out, np.full(16, 6.0))
    assert tr.records_sampled_out > 0
    assert tr.lanes()
    assert critical_path(tr).total_us >= 0.0


def test_instr_record_defaults_host_interval():
    """A record's interval is ``t_start``/``t_done``: it has no second,
    host pair and no gate, and the lane stamps default to None."""
    r = InstrRecord(0, 1, "device_kernel", "N0.device.0", "k", 0.0, 0.1, 0.2,
                    0.3, "dep", None, None, None)
    assert (r.t_start, r.t_done) == (0.2, 0.3)
    assert r.t_launched is None and r.t_synced is None
    for gone in ("t_host_start", "t_host_done", "card_gate", "on_card"):
        assert not hasattr(r, gone), gone
    with pytest.raises(TypeError):
        InstrRecord(0, 1, "device_kernel", "N0.device.0", "k", 0.0, 0.1, 0.2,
                    0.3, "dep", None, None, None, 0.2, 0.3, None)


# -- spans-only tracing ------------------------------------------------------------
def _spans_program(rt, steps=4, sleep_s=0.0):
    a = rt.buffer((64, 64), init=np.ones((64, 64)), name="A")

    def scale(chunk, av):
        if sleep_s:
            import time
            time.sleep(sleep_s)
        av.set(chunk, av.get(chunk) * 1.001)

    for i in range(steps):
        rt.submit(f"scale{i}", (64, 64), [read_write(a, one_to_one())],
                  scale)
    rt.sync()
    return rt


def _kinds(tracer):
    out = {}
    for spans in tracer.lanes().values():
        for s in spans:
            out[s.kind] = out.get(s.kind, 0) + 1
    return out


def test_spans_mode_creates_no_gate_and_no_timing_events():
    """A traced runtime's lanes stamp on the host: no gate, no timing
    event, no clock, and neither the tracer nor the lanes take a mode."""
    for trace in (True, "spans"):
        with Runtime(1, 2, trace=trace, device="cpu") as rt:
            assert type(rt.tracer) is Tracer
            assert not hasattr(rt.tracer, "mode")
            ex = rt.executors[0]
            assert not hasattr(ex.backend, "clock")
            for qs in ex.backend.device_queues:
                for q in qs:
                    assert not hasattr(q, "_gate")
                    assert not hasattr(q, "_start") and not hasattr(q, "_done")
                    assert q._work == q._run_stamped_host
    sink = backend.CompletionSink()
    q = backend.InOrderQueue("D0.q0", sink, stream=object(), stamped=True)
    try:
        assert q._work == q._run_stamped
        assert not hasattr(q, "_gate") and not hasattr(q, "_start")
    finally:
        q.shutdown()
    assert not hasattr(backend.Backend(
        1, device_of=lambda d: __import__("torch").device("cpu"),
        stamped=True), "clock")
    with pytest.raises(TypeError):
        backend.InOrderQueue("D0.q0", sink, mode="spans")
    with pytest.raises(TypeError):
        Tracer(mode="spans")


def test_trace_modes_choose_their_lane_path_once():
    paths = {}
    for trace in (False, True, "spans"):
        with Runtime(1, 1, trace=trace, device="cpu") as rt:
            paths[trace] = rt.executors[0].backend.device_queues[0][0]._work
    assert paths[False].__name__ == "_run_host"
    assert paths[True].__name__ == paths["spans"].__name__ == \
        "_run_stamped_host"
    for bad in ("gated", "timed"):
        with pytest.raises(ValueError):
            Runtime(1, 1, trace=bad, device="cpu")


@pytest.mark.parametrize("trace", [True, "spans"])
def test_spans_records_keep_their_stamps_in_order(trace):
    with _spans_program(Runtime(2, 2, trace=trace, device="cpu")) as rt:
        tr = rt.tracer
    stamped = [r for r in tr.records if r.t_synced is not None]
    assert stamped and {r.node for r in stamped} == {0, 1}
    for r in tr.records:
        if ".device." in r.lane or r.lane.split(".")[1] == "device":
            assert r.t_launched is not None, r
        if r.t_synced is None:
            assert r.t_launched is None
            continue
        assert (r.t_reg <= r.t_ready <= r.t_start <= r.t_launched
                <= r.t_synced <= r.t_done), r
    kinds = _kinds(tr)
    for kind in ("lane.queue", "lane.launch", "lane.sync", "exec.wake"):
        assert kinds[kind] == len(stamped), kind
    assert kinds["sched.cdag"] == kinds["sched.idag"] > 0
    util = rt.utilization_report()
    assert util["span_us"] > 0
    assert 0.0 <= rt.critical_path_report().scheduler_fraction <= 1.0


def test_throttle_has_its_own_span_outside_the_lowering_span():
    """With ``max_horizon_lag=1`` and a slow kernel the scheduler waits at
    its run-ahead limit: ``sched.throttle`` spans, each after the
    ``sched.idag`` span of its task, and the critical path counts no
    waiting as lowering."""
    with _spans_program(Runtime(1, 1, trace="spans", device="cpu",
                                max_horizon_lag=1, horizon_step=1),
                        steps=8, sleep_s=0.02) as rt:
        tr = rt.tracer
        rep = rt.critical_path_report()
    spans = [s for ss in tr.lanes().values() for s in ss]
    throttle = [s for s in spans if s.kind == "sched.throttle"]
    assert throttle
    idag = {s.meta["tid"]: s for s in spans if s.kind == "sched.idag"}
    for s in throttle:
        assert s.lane == "sched-N0"
        assert idag[s.meta["tid"]].t1 <= s.t0 + 1e-9
    waited = sum(s.t1 - s.t0 for s in throttle)
    lowered = sum(s.t1 - s.t0 for s in idag.values())
    assert waited > 0.05 > lowered
    assert rep.by_layer.get("scheduler", 0.0) <= (
        lowered + sum(s.t1 - s.t0 for s in spans
                      if s.kind == "sched.cdag")) * 1e6 + 1.0


def test_gc_collections_are_spans_until_shutdown():
    import gc
    n = len(gc.callbacks)
    for trace in (True, "spans"):
        rt = Runtime(1, 1, trace=trace, device="cpu")
        assert len(gc.callbacks) == n + 1
        gc.collect()
        spans = [s for s in rt.tracer.lanes().get("gc", [])
                 if s.kind == "gc.gen2"]
        assert spans and spans[-1].t0 <= spans[-1].t1
        assert spans[-1].meta["collected"] >= 0
        rt.shutdown()
        assert len(gc.callbacks) == n
        before = len(rt.tracer.spans)
        gc.collect()
        assert len(rt.tracer.spans) == before
    with Runtime(1, 1, device="cpu"):
        assert len(gc.callbacks) == n            # no tracer, no hook
    Tracer()
    assert len(gc.callbacks) == n                # nor a bare tracer


def test_tracer_stamp_converts_to_the_profiler_clock(tmp_path):
    """A tracer stamp taken next to a main-thread ``record_function``
    converts, through the trace's ``baseTimeNanoseconds``, to within 2 ms
    of that span's ``ts`` (median of 20 pairs)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer()
    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            stamps.append(tr.now())
            with record_function(f"probe{i}"):
                pass
    tr.close()
    path = tmp_path / "p.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    ts = {e["name"]: e["ts"] for e in data["traceEvents"]
          if e.get("ph") == "X" and e["name"].startswith("probe")}
    off = sorted(abs(tr.unix_us(t, base) - ts[f"probe{i}"])
                 for i, t in enumerate(stamps))
    assert off[len(off) // 2] < 2000.0


def test_wall_clock_anchors_follow_a_rate_difference():
    """Where the wall clock runs at another rate than ``perf_counter``,
    ``unix_us`` interpolates the offset between two anchors, holds the
    first before it and the last after it, and ``anchor()`` takes no
    anchor within ``ANCHOR_GAP_S`` of the last."""
    tr = Tracer()
    p0 = round(tr.epoch * 1e9)
    # the wall clock gains 5 ms over the 1 s after the epoch (5000 ppm)
    tr._anchors = [(p0, 0), (p0 + 10**9, 5_000_000)]
    assert tr.unix_us(0.0) == pytest.approx(p0 / 1e3, abs=1e-3)
    assert tr.unix_us(0.5) == pytest.approx(p0 / 1e3 + 0.5e6 + 2_500,
                                            abs=1e-3)
    assert tr.unix_us(1.0) == pytest.approx(p0 / 1e3 + 1e6 + 5_000,
                                            abs=1e-3)
    assert tr.unix_us(2.0) == pytest.approx(p0 / 1e3 + 2e6 + 5_000,
                                            abs=1e-3)
    assert tr.unix_us(-1.0) == pytest.approx(p0 / 1e3 - 1e6, abs=1e-3)
    fresh = Tracer()
    fresh.anchor()
    assert len(fresh._anchors) == 1           # within ANCHOR_GAP_S
    fresh._anchors[0] = (fresh._anchors[0][0] - 10**9, fresh._anchors[0][1])
    fresh.close()
    assert len(fresh._anchors) == 2           # the shutdown's anchor


def test_chrome_trace_export_is_on_the_wall_clock(tmp_path):
    """The export's ``ts`` are tracer times in microseconds, from a
    ``baseTimeNanoseconds`` that puts them on the wall clock, as a
    ``torch.profiler`` trace's are."""
    import time
    tr = Tracer()
    tr.close()
    tr.span("sched-N0", "sched.idag", "t", 1e-3, 2e-3, {"tid": 1})
    out = tmp_path / "t.json"
    tr.to_chrome_trace(out)
    data = json.loads(out.read_text())
    (ev,) = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert ev["ts"] == pytest.approx(1e3, abs=1e-3)
    base = data["baseTimeNanoseconds"]
    assert ev["ts"] + base / 1e3 == pytest.approx(tr.unix_us(1e-3), abs=1.0)
    assert abs(base / 1e9 - time.time()) < 5.0
    base = time.time_ns() - 10**15        # as a profiler's base, days back
    assert tr.unix_us(1e-3, base) - tr.unix_us(0.0, base) == pytest.approx(
        1e3, abs=1e-3)


def test_serving_spans_and_window_completion():
    from repro_torch.core import ServingRuntime
    with ServingRuntime(2, 1, trace="spans", device="cpu") as srv:
        t = srv.tenant("sim")
        a = t.buffer((32,), init=np.zeros(32), name="a")
        for _ in range(5):
            t.submit("inc", (32,), [read_write(a, one_to_one())],
                     lambda c, v: v.set(c, v.get(c) + 1))
            t.run().wait()
        tr = srv.tracer
        assert not srv.executors[0]._epoch_done_t   # dropped when seen
    spans = tr.lanes()["serve.sim"]
    kinds = {s.kind for s in spans}
    assert {"serve.wait", "serve.lower", "serve.replay", "sched.cdag",
            "sched.idag"} <= kinds
    waits = [s for s in spans if s.kind == "serve.wait"]
    assert len(waits) == 5
    for s in waits:
        assert s.meta["epoch_done"] <= s.t1
    assert max(s.t1 for s in waits) <= tr.now()

