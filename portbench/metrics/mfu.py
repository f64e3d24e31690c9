"""The whole step's share of the cards' float32 peak (without tensor cores):
the frozen operations of a step over the time of a step times the cards
times the peak, in percent."""

from portbench.counts import nbody, peaks


def read(obs):
    if not obs.units:
        return None
    step_s = obs.window_s / obs.units
    flops = nbody.step_flops(int(obs.config["bodies"]))
    return 100.0 * flops / (step_s * obs.cards
                            * peaks()["float32_flops_per_s"])
