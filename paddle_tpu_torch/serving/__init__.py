"""Serving: continuous batching over a paged KV pool (the port of
``paddle_tpu.serving``'s engine, scheduler, KV cache and step watchdog),
with the JAX engine's fault sites, bounded prefill replay, graceful drain,
metrics and traces; and the tiers above one engine: the health-aware
pick-2 :class:`Router` over several replicas with at-most-once failover,
the streaming HTTP :class:`FrontDoor`, and the :class:`FleetSupervisor`
that runs each replica in a worker process of its own and respawns it
when it dies."""

from .engine import (TPOT_BUCKETS, TTFT_BUCKETS, DecodeGraph, DrainTimeout,
                     Engine, EngineStopped, PrefillGraph, ServingConfig,
                     prefill_body)
from .kv_cache import KVCacheConfig, PagedKVCache, prefix_chain_digests
from .scheduler import (DeadlineExceeded, GenerationRequest, GenerationResult,
                        QueueFull, Scheduler)
from .watchdog import StepWatchdog, WatchdogTimeout
from .router import NoHealthyReplica, Replica, Router, RouterConfig
from .http import FrontDoor, retry_after_s, status_for
from .fleet import (FleetSupervisor, FleetWorkerLost, FleetWorkerSpec,
                    ProcessReplica, RemoteEngine)

__all__ = ["DeadlineExceeded", "DecodeGraph", "DrainTimeout", "Engine",
           "EngineStopped", "FleetSupervisor", "FleetWorkerLost",
           "FleetWorkerSpec", "FrontDoor", "GenerationRequest",
           "GenerationResult", "KVCacheConfig", "NoHealthyReplica",
           "PagedKVCache", "PrefillGraph", "ProcessReplica", "QueueFull",
           "RemoteEngine", "Replica", "Router", "RouterConfig", "Scheduler",
           "ServingConfig", "StepWatchdog", "TPOT_BUCKETS", "TTFT_BUCKETS",
           "WatchdogTimeout", "prefill_body", "prefix_chain_digests",
           "retry_after_s", "status_for"]
