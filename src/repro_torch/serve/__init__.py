from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.scheduler import Request, RequestScheduler

__all__ = ["GenerationResult", "Request", "RequestScheduler", "ServeEngine"]
