"""Kernel B3's share of its roofline in a training cell: the frozen
operations of the forward launches found in the trace (causal attention
over the traffic's ``batch`` sequences of ``seq_len``, every query head,
``counts/flash_attention.py``) over the dense bf16 peak, over the union of
their intervals, in percent.  Every launch of the cell is one attention
layer's forward or its recompute, all of one shape."""

from portbench.counts import flash_attention, granite_hybrid

NAMES = ("flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel")


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    found = tl.kernels(NAMES)
    if not found:
        return None
    cfg, tr = obs.config, obs.traffic
    heads = cfg["num_attention_heads"]
    flops = len(found) * flash_attention.flops(
        int(tr["batch"]), int(tr["seq_len"]), heads,
        cfg["hidden_size"] // heads)
    return 100.0 * flops / granite_hybrid.bf16_peak() / tl.union_s(found)
