"""The readings of the runtime's spans (``harness/program.py``) on
synthetic timelines, and ``spans.py`` on a tiny cell on the CPU."""

import importlib.util
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import program
from portbench.harness.spec import load_cell
from portbench.harness.trace import Timeline

ROOT = Path(__file__).resolve().parents[2]


def span(name, s, e, lane="x", **meta):
    return (name, lane, float(s), float(e), meta)


def timeline(busy, window=(0.0, 100.0)):
    """One card, busy over ``busy`` (microseconds)."""
    return Timeline(window, [0], [(0, "k", s, e) for s, e in busy])


def test_order_ranks_prefixes_and_names():
    assert [program.rank(n) for n in
            ("gc.gen2", "lane.launch", "exec.wake", "lane.queue",
             "serve.wait", "sched.idag", "sched.cdag", "sched.throttle",
             "lane.sync")] == list(range(9))
    assert program.rank("serve.replay") == program.rank("serve.lower")
    assert program.rank("device_kernel") is None
    assert program.rank("task") is None and program.rank("gc") is None


def test_idle_goes_to_the_first_open_span_of_the_order():
    spans = [span("sched.cdag", 0, 40), span("exec.wake", 10, 20),
             span("gc.gen2", 15, 18), span("lane.sync", 30, 60),
             span("device_kernel", 0, 100)]
    by = program.idle_by_name([(0, 50), (70, 80)], spans)
    # 0-10 cdag, 10-15 wake, 15-18 gc, 18-20 wake, 20-40 cdag (over sync),
    # 40-50 sync, 70-80 nothing
    assert by == pytest.approx({"sched.cdag": 30, "exec.wake": 7,
                                "gc.gen2": 3,
                                "lane.sync": 10, "(untraced)": 10})
    assert sum(by.values()) == pytest.approx(60)


def test_idle_of_overlapping_spans_of_one_name_counts_once():
    spans = [span("lane.launch", 0, 30), span("lane.launch", 10, 40)]
    assert program.idle_by_name([(5, 50)], spans) == pytest.approx(
        {"lane.launch": 35, "(untraced)": 10})


def test_idle_share_and_top_names_on_a_timeline():
    tl = timeline([(0, 20), (40, 90)])          # idle 20-40 and 90-100
    spans = [span("lane.queue", 18, 30), span("serve.wait", 25, 100),
             span("exec.wake", 92, 95)]
    assert program.idle_traced_share(tl, spans) == pytest.approx(100.0)
    assert program.idle_by_program(tl, spans) == [
        ["serve.wait", pytest.approx(17e-6)],
        ["lane.queue", pytest.approx(10e-6)],
        ["exec.wake", pytest.approx(3e-6)]]
    half = [span("lane.queue", 20, 30)]
    assert program.idle_traced_share(tl, half) == pytest.approx(100 / 3)
    assert program.idle_by_program(tl, half)[0] == [
        "(untraced)", pytest.approx(20e-6)]
    gaps = program.longest_gaps(tl, half, top=1)
    assert gaps == [[pytest.approx(20e-6), pytest.approx(20e-6),
                     [["lane.queue", pytest.approx(10e-6)],
                      ["(untraced)", pytest.approx(10e-6)]]]]


def test_detail_puts_host_instructions_before_the_client():
    tl = timeline([(0, 20), (60, 100)])         # idle 20-60
    spans = [span("serve.wait", 10, 70), span("instr.coll_send", 30, 40),
             span("task", 0, 100)]
    assert program.idle_by_program(tl, spans) == [
        ["serve.wait", pytest.approx(40e-6)]]
    assert program.longest_gaps(tl, spans) == [[
        pytest.approx(40e-6), pytest.approx(20e-6),
        [["serve.wait", pytest.approx(30e-6)],
                               ["instr.coll_send", pytest.approx(10e-6)]]]]
    assert program.rank("task") is None
    assert program.rank("task", program.DETAIL) is not None


def test_no_spans_read_nothing():
    tl = timeline([(0, 50)])
    assert program.idle_traced_share(tl, []) is None
    assert program.idle_by_program(tl, []) == []
    assert program.lower_us_per_step([], (0, 100), 5) is None
    assert program.median_us([], (0, 100), "lane.launch") is None
    assert program.window_wake_us_p50([], (0, 100)) is None


def test_lowering_is_clipped_to_the_window_and_per_step():
    spans = [span("sched.cdag", -10, 10), span("sched.idag", 10, 30),
             span("sched.throttle", 30, 90), span("sched.idag", 95, 120,
                                                  lane="sched-N1")]
    assert program.lower_us_per_step(spans, (0, 100), 5) == pytest.approx(
        (10 + 20 + 5) / 5)


def test_medians_take_the_spans_that_start_in_the_window():
    spans = [span("lane.launch", -5, 1), span("lane.launch", 10, 12),
             span("lane.launch", 20, 26), span("lane.launch", 30, 34),
             span("exec.wake", 40, 41)]
    assert program.median_us(spans, (0, 100), "lane.launch") == 4.0
    assert program.median_us(spans, (0, 100), "exec.wake") == 1.0
    waits = [span("serve.wait", 0, 50, epoch_done=45.0),
             span("serve.wait", 50, 90, epoch_done=80.0),
             span("serve.wait", 90, 130, epoch_done=100.0),
             span("serve.wait", 10, 20)]
    assert program.window_wake_us_p50(waits, (0, 100)) == 7.5


def test_program_spans_convert_and_skip_a_program_without_them():
    from repro_torch.core import Tracer
    import time
    tr = Tracer()
    tr.close()
    base = time.time_ns() - 10**15        # as a profiler's base, days back
    w0 = tr.unix_us(1.0, base)
    tr.span("sched-N0", "sched.idag", "t", 1.0, 1.001, {"tid": 3})
    tr.span("serve.c", "serve.wait", "c", 1.002, 1.003,
            {"epoch_done": 1.0025})
    tr.span("main", "task", "t", 1.0, 1.001)
    tr.span("N0.host", "copy", "c", 1.0, 1.001)
    tr.span("N0.device.0", "device_kernel", "k", 1.0, 1.001)
    tr.span("sched-N0", "sched.cdag", "t", 9.0, 9.001)
    spans = program.program_spans(tr, base, (w0, w0 + 5e3))
    assert sorted((n, lane) for n, lane, *_ in spans) == [
        ("instr.copy", "N0.host"), ("sched.idag", "sched-N0"),
        ("serve.wait", "serve.c"), ("task", "main")]
    (_, _, s, e, m), = [x for x in spans if x[0] == "sched.idag"]
    (_, _, _, e2, m2), = [x for x in spans if x[0] == "serve.wait"]
    assert (s - w0, e - w0) == (pytest.approx(0.0, abs=1e-3),
                                pytest.approx(1e3, abs=1e-3))
    assert m == {"tid": 3} and e2 - m2["epoch_done"] == pytest.approx(500)
    assert program.program_spans(None, base, (0, 1)) == []
    assert program.program_spans(tr, None, (0, 1)) == []
    parent = SimpleNamespace(lanes=tr.lanes)     # a tracer without unix_us
    assert program.program_spans(parent, base, (w0, w0 + 5e3)) == []


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with a 256-body N-body and its two cells."""
    tmp = tmp_path_factory.mktemp("bench")
    bench = tmp / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "nbody-2p19.json").read_text())
    cfg.update(name="nbody-tiny", bodies=256)
    (bench / "configs" / "nbody-tiny.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "nbody-tiny", "source": "test",
                            "file": "portbench/configs/nbody-tiny.json",
                            "reduced": [], "why": "test"})
    for traffic in ("2x2.steps", "2x2.served"):
        spec["workloads"].append({"name": f"nbody-tiny.{traffic}",
                                  "config": "nbody-tiny",
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(
            w.replace("nbody-2p19", "nbody-tiny")
            for w in list(m.get("workloads", []))
            if w.startswith("nbody-2p19"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    mod = importlib.util.spec_from_file_location("portbench_spans_tool",
                                                 ROOT / "portbench" /
                                                 "spans.py")
    tool = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(tool)
    return tmp, bench, tool


@pytest.mark.parametrize("traffic", ["2x2.steps", "2x2.served"])
def test_spans_tool_reads_a_tiny_cell(tiny, traffic):
    tmp, bench, tool = tiny
    cell = load_cell(tmp / "BENCHMARK.json", f"nbody-tiny.{traffic}",
                     root=bench)
    on = tool.traced_run(cell, 2**31 + 11, 0.4, True, True, "cpu")
    assert on["units"] > 0
    assert all(v <= cell.config["limits"][k] for k, v in on["checks"].items())
    readings = on["program"]
    assert readings["idle_traced_share"] > 50.0
    assert readings["launch_us_p50"] > 0 and readings["wake_us_p50"] > 0
    if traffic == "2x2.steps":
        assert readings["lower_us_per_step"] > 0
        assert readings["window_wake_us_p50"] is None
    else:
        assert readings["window_wake_us_p50"] >= 0
    assert on["idle_by_program"] and on["longest_gaps"]
    assert abs(on["clock_offset_us"]) < 50e3
    off = tool.traced_run(cell, 2**31 + 11, 0.2, False, False, "cpu")
    assert "program" not in off and "checks" not in off
    assert set(off["metrics"]) == set(on["metrics"])
