"""The median of the same windows as ``window_p95_ms``, in milliseconds:
the part of a window that a steady client always waits."""

import numpy as np


def read(obs):
    if not obs.latencies_s:
        return None
    return float(np.percentile(obs.latencies_s, 50)) * 1e3
