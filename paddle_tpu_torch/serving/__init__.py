"""Serving: continuous batching over a paged KV pool (the port of
``paddle_tpu.serving``'s engine, scheduler and KV cache)."""

from .engine import (DecodeGraph, DrainTimeout, Engine, EngineStopped,
                     ServingConfig)
from .kv_cache import KVCacheConfig, PagedKVCache, prefix_chain_digests
from .scheduler import (DeadlineExceeded, GenerationRequest, GenerationResult,
                        QueueFull, Scheduler)

__all__ = ["DeadlineExceeded", "DecodeGraph", "DrainTimeout", "Engine",
           "EngineStopped", "GenerationRequest", "GenerationResult",
           "KVCacheConfig", "PagedKVCache", "QueueFull", "Scheduler",
           "ServingConfig", "prefix_chain_digests"]
