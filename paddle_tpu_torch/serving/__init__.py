"""Serving: continuous batching over a paged KV pool (the port of
``paddle_tpu.serving``'s engine, scheduler, KV cache and step watchdog),
with the JAX engine's fault sites, bounded prefill replay, graceful drain,
metrics and traces."""

from .engine import (TPOT_BUCKETS, TTFT_BUCKETS, DecodeGraph, DrainTimeout,
                     Engine, EngineStopped, PrefillGraph, ServingConfig,
                     prefill_body)
from .kv_cache import KVCacheConfig, PagedKVCache, prefix_chain_digests
from .scheduler import (DeadlineExceeded, GenerationRequest, GenerationResult,
                        QueueFull, Scheduler)
from .watchdog import StepWatchdog, WatchdogTimeout

__all__ = ["DeadlineExceeded", "DecodeGraph", "DrainTimeout", "Engine",
           "EngineStopped", "GenerationRequest", "GenerationResult",
           "KVCacheConfig", "PagedKVCache", "PrefillGraph", "QueueFull",
           "Scheduler", "ServingConfig", "StepWatchdog", "TPOT_BUCKETS",
           "TTFT_BUCKETS", "WatchdogTimeout", "prefill_body",
           "prefix_chain_digests"]
