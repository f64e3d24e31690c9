"""Kernel B4's share of its roofline in a training cell: the frozen bytes
of the forward launches found in the trace (``counts/ssd_scan.py``: one
Mamba2 layer's scan over the traffic's ``batch`` sequences of ``seq_len``,
bf16 activations) over the memory bandwidth, over the union of their
intervals, in percent."""

from portbench.counts import peaks, ssd_scan

NAMES = ("ssd_scan_bf16_kernel", "ssd_scan_f32_kernel")


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    found = tl.kernels(NAMES)
    if not found:
        return None
    cfg, tr = obs.config, obs.traffic
    moved = len(found) * ssd_scan.bytes_moved(
        int(tr["batch"]), int(tr["seq_len"]), cfg["mamba_n_heads"],
        cfg["mamba_d_head"], cfg["mamba_d_state"])
    return 100.0 * moved / peaks()["hbm_bytes_per_s"] / tl.union_s(found)
