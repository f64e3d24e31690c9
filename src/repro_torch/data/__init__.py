# Copied from src/repro/data/__init__.py.
from .pipeline import SyntheticLMData, Prefetcher

__all__ = ["SyntheticLMData", "Prefetcher"]
