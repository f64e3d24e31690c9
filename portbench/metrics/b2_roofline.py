"""Kernel B2's share of its roofline: the frozen bytes of the stencil
launches found in the trace over the memory bandwidth, over the time in
which a card ran them (the union of their intervals on each card), in
percent.  Every launch of a step covers an equal share of the rows."""

from portbench.counts import peaks, stencil5

NAMES = ("wave_rows_kernel",)


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    found = tl.kernels(NAMES)
    if not found:
        return None
    busy = tl.union_s(found)
    h, w = int(obs.config["height"]), int(obs.config["width"])
    devs = int(obs.traffic["nodes"]) * int(obs.traffic["devices"])
    moved = len(found) * stencil5.bytes_moved(h // devs, w)
    return 100.0 * moved / peaks()["hbm_bytes_per_s"] / busy
