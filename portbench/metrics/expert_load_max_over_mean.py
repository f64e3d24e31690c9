"""How unevenly the router loads the experts held here: per layer, the
token assignments of its busiest held expert over the mean of its held
experts, from the counter ``moe_dropless.assigned`` over the window; the
largest over the layers.  1 is even."""


def read(obs):
    counts = obs.counters.get("expert_assignments")
    if not counts:
        return None
    layers: dict = {}
    for (layer, _), c in counts.items():
        layers.setdefault(layer, []).append(c)
    ratios = [max(cs) / (sum(cs) / len(cs)) for cs in layers.values()
              if sum(cs) > 0]
    return max(ratios) if ratios else None
