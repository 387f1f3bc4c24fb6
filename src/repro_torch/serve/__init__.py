"""Batched serving engine with continuous batching."""
from .engine import ServeEngine, ContinuousBatcher, Request, Completion
__all__ = ["ServeEngine", "ContinuousBatcher", "Request", "Completion"]
