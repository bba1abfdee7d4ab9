"""Serving: continuous batching over a paged KV pool (the port of
``paddle_tpu.serving``'s engine, scheduler and KV cache)."""

from .engine import (DecodeGraph, DrainTimeout, Engine, EngineStopped,
                     PrefillGraph, ServingConfig, prefill_body)
from .kv_cache import KVCacheConfig, PagedKVCache, prefix_chain_digests
from .scheduler import (DeadlineExceeded, GenerationRequest, GenerationResult,
                        QueueFull, Scheduler)

__all__ = ["DeadlineExceeded", "DecodeGraph", "DrainTimeout", "Engine",
           "EngineStopped", "GenerationRequest", "GenerationResult",
           "KVCacheConfig", "PagedKVCache", "PrefillGraph", "QueueFull",
           "Scheduler", "ServingConfig", "prefill_body",
           "prefix_chain_digests"]
