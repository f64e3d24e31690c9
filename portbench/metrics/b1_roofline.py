"""Kernel B1's share of its roofline: the frozen operations of the force
launches found in the trace over the float32 peak, over the time in which
a card ran them (the union of their intervals on each card, so launches of
several devices that share a card count once), in percent.  Every launch
of a step covers an equal share of the rows."""

from portbench.counts import nbody, peaks

NAMES = ("nbody_rows_kernel",)


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    found = tl.kernels(NAMES)
    if not found:
        return None
    busy = tl.union_s(found)
    n = int(obs.config["bodies"])
    devs = int(obs.traffic["nodes"]) * int(obs.traffic["devices"])
    flops = len(found) * nbody.flops(n // devs, n)
    return 100.0 * flops / peaks()["float32_flops_per_s"] / busy
