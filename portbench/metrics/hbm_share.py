"""The whole step's share of the cards' memory bandwidth: the frozen bytes
of a step over the time of a step times the cards times the peak, in
percent."""

from portbench.counts import peaks, stencil5


def read(obs):
    if not obs.units:
        return None
    step_s = obs.window_s / obs.units
    moved = stencil5.step_bytes(int(obs.config["height"]),
                                int(obs.config["width"]))
    return 100.0 * moved / (step_s * obs.cards * peaks()["hbm_bytes_per_s"])
