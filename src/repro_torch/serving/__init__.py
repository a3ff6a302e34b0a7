"""OT as a service: the persistent serving layer over the batched engine.

  service      — OTService: the submit / pump / drain request loop, stats,
                 and the recovery ladder's serving executor
  runner_cache — bucket-keyed pre-captured solve loops (no capture after
                 warmup)
  admission    — max-batch / max-wait continuous batching of ragged
                 requests
  warmstart    — fingerprinted potential cache for repeat and near-repeat
                 pairs
  traffic      — synthetic heavy-tailed open-loop traffic and its report
  streaming    — StreamingOTService: coalesced mutations over paged
                 supports, one warm re-solve a pair a flush

Counterpart of ``repro.serving``.
"""
from .admission import AdmissionQueue, QueueFullError
from .runner_cache import BucketRunner, RunnerCache
from .service import OTService, QuarantineError, Refusal, Ticket
from .streaming import MutationTicket, StreamingOTService
from .traffic import (
    Request,
    TrafficReport,
    TrafficSpec,
    make_traffic,
    run_open_loop,
    traffic_cells,
)
from .warmstart import WarmHit, WarmStartCache, fingerprint, request_keys

__all__ = [
    "AdmissionQueue",
    "BucketRunner",
    "MutationTicket",
    "OTService",
    "QuarantineError",
    "QueueFullError",
    "Refusal",
    "StreamingOTService",
    "Request",
    "RunnerCache",
    "Ticket",
    "TrafficReport",
    "TrafficSpec",
    "WarmHit",
    "WarmStartCache",
    "fingerprint",
    "make_traffic",
    "request_keys",
    "run_open_loop",
    "traffic_cells",
]
