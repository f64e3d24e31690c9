"""Serving loop of the port."""

from .serve_loop import Request, ServeLoop

__all__ = ["Request", "ServeLoop"]
