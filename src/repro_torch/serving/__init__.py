"""Serving front ends of the port: the admission queue and the streaming
service. ``OTService``, the runner cache and the warm-start cache of the
JAX package's ``repro.serving`` are not ported yet."""
from .admission import AdmissionQueue, QueueFullError
from .streaming import MutationTicket, StreamingOTService

__all__ = [
    "AdmissionQueue",
    "QueueFullError",
    "MutationTicket",
    "StreamingOTService",
]
