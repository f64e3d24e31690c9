"""The share of the traced window in which no kernel, copy or memset ran,
per card, averaged over the cell's cards, in percent."""


def read(obs):
    tl = obs.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
