"""The 95th percentile of every window of the waiting client in the window,
each from the submission of its steps to the return of its wait, in
milliseconds."""

import numpy as np


def read(obs):
    if not obs.latencies_s:
        return None
    return float(np.percentile(obs.latencies_s, 95)) * 1e3
