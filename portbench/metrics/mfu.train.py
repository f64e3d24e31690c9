"""The whole training step's share of the card's dense bf16 peak: the
frozen operations of a step (``counts/granite_hybrid.py``: 6 per active
parameter held here per token, plus attention's) over ``step_ms`` times the
cards times 989e12, in percent."""

from portbench.counts import granite_hybrid


def read(obs):
    if not obs.units:
        return None
    step_s = obs.window_s / obs.units
    tr = obs.traffic
    flops = granite_hybrid.step_flops(obs.config, int(tr["batch"]),
                                      int(tr["seq_len"]))
    return 100.0 * flops / (step_s * obs.cards * granite_hybrid.bf16_peak())
