"""The whole window over the steps completed in it, in milliseconds."""


def read(obs):
    return obs.window_s / obs.units * 1e3 if obs.units else None
