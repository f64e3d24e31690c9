"""Instructions the schedulers emitted in the window (``rt.total_instructions()``)
over the steps submitted."""


def read(obs):
    n = obs.counters.get("instructions")
    return n / obs.units if n is not None and obs.units else None
