"""The median gap between consecutive activities (kernels, copies, memsets)
of each card inside the traced window, in microseconds."""

import numpy as np


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    gaps = []
    for card in tl.cards:
        busy = tl.busy(card)
        gaps += [b[0] - a[1] for a, b in zip(busy, busy[1:])]
    return float(np.median(gaps)) if gaps else None
