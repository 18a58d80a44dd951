"""Continuous-batching serving engine on the paged KV pool."""

from repro_torch.serving.engine import Completion, Request, ServingEngine

__all__ = ["Completion", "Request", "ServingEngine"]
