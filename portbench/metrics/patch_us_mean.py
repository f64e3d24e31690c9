"""The memo's mean time to patch a replayed window
(``memo_stats()["patch_us"]``) over the window, in microseconds."""


def read(obs):
    n = obs.counters.get("patch_count")
    return obs.counters["patch_sum_us"] / n if n else None
