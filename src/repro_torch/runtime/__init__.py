"""Serving and training loops of the port."""

from .elastic import ElasticTrainer, rebalance_weights
from .serve_loop import Request, ServeLoop
from .train_loop import TrainLoop, TrainMetrics, train

__all__ = ["ElasticTrainer", "Request", "ServeLoop", "TrainLoop",
           "TrainMetrics", "rebalance_weights", "train"]
