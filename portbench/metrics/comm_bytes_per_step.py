"""Bytes the communicator sent in the window (``rt.comm_stats()["bytes"]``)
over the steps."""


def read(obs):
    n = obs.counters.get("comm_bytes")
    return n / obs.units if n is not None and obs.units else None
