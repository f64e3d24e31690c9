"""The serving runtime's memo: windows replayed over windows submitted in
the window (``memo_stats()`` hits over hits plus misses), in percent."""


def read(obs):
    hits = obs.counters.get("memo_hits")
    misses = obs.counters.get("memo_misses")
    if hits is None or hits + misses == 0:
        return None
    return 100.0 * hits / (hits + misses)
