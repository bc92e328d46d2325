"""Continuous-batching inference subsystem of the PyTorch port: the engine
owns batching, paged KV management, prefix caching and speculation."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.layouts import KVLayout, layout_for
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged import PagedKVCachePool
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.spec import DrafterPool, NGramDrafter

__all__ = ["ServingEngine", "PagedKVCachePool", "KVLayout", "layout_for",
           "ServingMetrics", "Request", "Scheduler", "SamplingParams",
           "GREEDY", "NGramDrafter", "DrafterPool"]
