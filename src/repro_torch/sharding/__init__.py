"""Sharding rules of the port over torch ``DeviceMesh`` placements."""

from .rules import param_shardings, batch_shardings, cache_shardings
from .partition import named, data_axes, model_axis

__all__ = ["param_shardings", "batch_shardings", "cache_shardings",
           "named", "data_axes", "model_axis"]
