"""Continuous-batching serving engine of the torch port."""
from repro_torch.serving.engine import Engine, EngineStats
from repro_torch.serving.request import Request, RequestStatus, SamplingParams

__all__ = ["Engine", "EngineStats", "Request", "RequestStatus",
           "SamplingParams"]
