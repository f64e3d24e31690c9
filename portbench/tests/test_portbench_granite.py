"""The granite training cell: found by name; on the CPU at a tiny size the
program passes every limit and each control fails one; a planted fault
reads ``correct`` false; the frozen counts agree with the program's own
parameter count; the new metric readers on synthetic observations.

The tiny runs compute in float32 (the configuration states bfloat16): the
limits are set from the card's readings at the published widths, where
bfloat16's gaps come from sums over 16,384 tokens; at 128 tokens they are
larger.  Float32 reads near zero, so the controls' readings stand against
the limits alone."""

import json
import sys
from pathlib import Path

import pytest
import torch

from portbench.apps import granite_hybrid as app_mod
from portbench.counts import flash_attention, granite_hybrid, ssd_scan
from portbench.harness.common import Observation
from portbench.harness.main import run_cell
from portbench.harness.spec import load_cell
from portbench.harness.trace import Timeline

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "portbench"))
from control import readings  # noqa: E402

WORKLOAD = "granite-4.0-h-small-10l.2x8192.train"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 32, "shared_intermediate_size": 48,
        "vocab_size": 256, "router_experts": 8, "num_local_experts": 2,
        "num_experts_per_tok": 3, "mamba_n_heads": 4, "mamba_d_head": 32,
        "mamba_d_state": 16, "mamba_chunk_size": 32, "b4_chunk": 16,
        "attention_multiplier": 1 / 16, "dtype": "float32"}


def tiny(seq_len=64):
    cell = load_cell(ROOT / "BENCHMARK.json", WORKLOAD)
    cell.config.update(TINY)
    cell.traffic.update(seq_len=seq_len)
    return cell


def test_cell_is_found_by_name():
    cell = load_cell(ROOT / "BENCHMARK.json", WORKLOAD)
    assert cell.chips == 1 and cell.traffic["loop"] == "train"
    assert cell.config["app"] == "granite_hybrid"
    assert (cell.traffic["batch"], cell.traffic["seq_len"]) == (2, 8192)
    assert [m["name"] for m in cell.end_to_end] == ["step_ms", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "mfu.train", "b3_roofline", "b4_roofline",
        "expert_load_max_over_mean", "idle_share.train"}
    assert cell.metric_reader("idle_share.train").__file__.endswith(
        "idle_share.py")
    assert set(cell.config["limits"]) == set(app_mod.CHECKS)


def test_configuration_keeps_the_published_numbers():
    """Every number of the published config.json under its key, but the
    cut, which ``reduced`` lists."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "granite-4.0-h-small-10l.json").read_text())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"]
                 if c["name"] == "granite-4.0-h-small-10l")
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert (cfg["num_hidden_layers"], cfg["num_local_experts"],
            cfg["vocab_size"], cfg["router_experts"]) == (10, 9, 12544, 72)
    assert cfg["layer_types"] == ["mamba"] * 5 + ["attention"] + \
        ["mamba"] * 4
    assert (cfg["hidden_size"], cfg["intermediate_size"],
            cfg["shared_intermediate_size"], cfg["mamba_n_heads"],
            cfg["mamba_d_head"], cfg["mamba_d_state"]) == \
        (4096, 768, 1536, 128, 64, 128)


def test_program_passes_every_limit_and_each_control_fails_one():
    cell = tiny()
    limits = cell.config["limits"]
    for seed in (3, 2**31 + 5):
        r = readings(cell, seed, 0.3, "cpu")
        assert all(v <= limits[k] for k, v in r["program"].items()), r
        assert set(r["control"]) == set(app_mod.App.CONTROLS), r
        for control in r["control"].values():
            assert any(v > limits[k] for k, v in control.items()), r


# -- planted faults ------------------------------------------------------------
def skipped_moe(mp):
    """The routed experts' part left out of every layer."""
    from repro_torch.models import layers as L

    def skip(p, x, **kw):
        return torch.zeros_like(x)
    skip.assigned, skip.absent, skip.dropped = {}, 0, 0
    mp.setattr(L, "moe_dropless", skip)


def rotary_applied(mp):
    """Attention with rotary positions, where the model has none."""
    import dataclasses
    from repro_torch.models import layers as L
    attention = L.attention

    def with_rope(p, cfg, *args, **kw):
        return attention(p, dataclasses.replace(cfg, rope_theta=1e4), *args,
                         **kw)
    mp.setattr(L, "attention", with_rope)


def shared_expert_skipped(mp):
    """The shared expert left out."""
    from repro_torch.models import layers as L
    mlp = L.mlp

    def no_shared(p, cfg, x):
        return mlp(p, cfg, x) * (0.0 if cfg.family == "hybrid_moe" else 1.0)
    mp.setattr(L, "mlp", no_shared)


def adamw_update_skipped(mp):
    """The optimizer's step left out: the weights stay as they were."""
    from repro_torch.launch import steps

    def unchanged(params, grads, state, **kw):
        return params, {**state, "step": state["step"] + 1}, \
            torch.zeros(())
    mp.setattr(steps, "adamw_update", unchanged)


def adamw_lr_doubled(mp):
    """The optimizer's step at twice the traffic's learning rate."""
    from repro_torch.launch import steps
    update = steps.adamw_update

    def doubled(params, grads, state, *, lr, **kw):
        return update(params, grads, state, lr=2 * lr, **kw)
    mp.setattr(steps, "adamw_update", doubled)


def adamw_weight_decay_skipped(mp):
    """The optimizer's step without its weight decay."""
    from repro_torch.launch import steps
    update = steps.adamw_update

    def no_decay(params, grads, state, **kw):
        return update(params, grads, state, weight_decay=0.0, **kw)
    mp.setattr(steps, "adamw_update", no_decay)


FAULTS = [None, skipped_moe, rotary_applied, shared_expert_skipped,
          adamw_update_skipped, adamw_lr_doubled, adamw_weight_decay_skipped]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__ if f else "sound" for f in FAULTS])
def test_fault_reads_not_correct(monkeypatch, fault):
    cell = tiny()
    if fault is not None:
        fault(monkeypatch)
    result = run_cell(cell, 2**31 + 77, 0.3, False, "cpu", 0.0)
    assert result["correct"] is (fault is None), result["checks"]
    if fault in (adamw_update_skipped, adamw_lr_doubled):
        # an update left out, or twice as long, is off by its whole length
        assert result["checks"]["update_gap"]["value"] == pytest.approx(
            1, abs=1e-3)


# -- counts and readers ----------------------------------------------------------
@pytest.mark.parametrize("tiny_size", [False, True])
def test_counts_agree_with_the_programs_param_count(tiny_size):
    cell = tiny() if tiny_size else load_cell(ROOT / "BENCHMARK.json",
                                              WORKLOAD)
    arch = app_mod.arch_config(cell.config)
    for active in (False, True):
        assert granite_hybrid.held_params(cell.config, active) == \
            arch.param_count(active_only=active)
    if not tiny_size:
        assert arch.param_count() == 2_055_031_424


def test_counts_by_hand():
    # 3 causal positions: 6 pairs; 4 hd operations a pair a head
    assert flash_attention.pairs(3) == 6 and flash_attention.pairs(3, False) \
        == 9
    assert flash_attention.flops(2, 3, 5, 8) == 4 * 2 * 5 * 8 * 6
    # x, y: 1*2*3*4 bf16 each; B, C: 1*2*5 bf16; a: 1*2*3 f32; state 3*4*5
    assert ssd_scan.bytes_moved(1, 2, 3, 4, 5) == \
        (24 + 2 * 10) * 2 + 6 * 4 + 24 * 2 + 60 * 4
    cfg = load_cell(ROOT / "BENCHMARK.json", WORKLOAD).config
    tokens = 2 * 8192
    assert granite_hybrid.step_flops(cfg, 2, 8192) == \
        6 * 1_323_649_664 * tokens + 12 * 8192 * 4096 * tokens
    assert granite_hybrid.bf16_peak() == 989e12


def _observation(cell, device=(), counters=None):
    obs = Observation(cell.name, cell.config, cell.traffic, cards=1,
                      units=4, window_s=8.0, counters=counters or {})
    if device is not None:
        obs.timeline = Timeline((0.0, 8e6), [0], list(device))
    return obs


def test_readers_on_synthetic_observations():
    cell = load_cell(ROOT / "BENCHMARK.json", WORKLOAD)
    read = {m: cell.metric_reader(m).read for m in
            ("mfu.train", "b3_roofline", "b4_roofline",
             "expert_load_max_over_mean")}
    # two B3 launches of 10 ms, overlapping by half; one B4 launch of 1 ms
    dev = [(0, "void flash_fwd_wgmma_kernel<2>(CUtensorMap)", 0.0, 1e4),
           (0, "void flash_fwd_wgmma_kernel<2>(CUtensorMap)", 5e3, 1.5e4),
           (0, "ssd_scan_bf16_kernel", 2e4, 2.1e4)]
    counts = {"expert_assignments": {(0, 0): 10, (0, 1): 30, (1, 0): 20,
                                     (1, 1): 20}}
    obs = _observation(cell, dev, counts)
    flops = 2 * flash_attention.flops(2, 8192, 32, 128)
    assert read["b3_roofline"](obs) == pytest.approx(
        100 * flops / 989e12 / 0.015)
    moved = ssd_scan.bytes_moved(2, 8192, 128, 64, 128)
    assert read["b4_roofline"](obs) == pytest.approx(
        100 * moved / 3.35e12 / 0.001)
    assert read["expert_load_max_over_mean"](obs) == pytest.approx(1.5)
    assert read["mfu.train"](obs) == pytest.approx(
        100 * granite_hybrid.step_flops(cell.config, 2, 8192) / 2.0 / 989e12)
    # a program without the kernels or the counter reads nothing
    bare = _observation(cell, [], {})
    assert all(read[m](bare) is None for m in
               ("b3_roofline", "b4_roofline", "expert_load_max_over_mean"))
    assert read["b3_roofline"](_observation(cell, None)) is None
