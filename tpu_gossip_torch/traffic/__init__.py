"""Streaming serving plane: sustained many-message traffic on the slot/Bloom
dedup engine.

Ports ``tpu_gossip/traffic/``'s plan and round halves: ``compile_stream``
turns an injection rate and an origin law into a :class:`CompiledStream`;
``slot_expiry`` and ``apply_stream`` run as the streaming stages of the
shared round on every engine, drawing from the registered
``TRAFFIC_STREAM_SALT`` stream at the global shape, so a stream's run
equals the JAX package's bit for bit. ``apply_arrivals``
(``traffic/ingest.py``) is the deterministic twin the serving frontend
(``serve/``) feeds: host-batched real arrivals land with the same lease and
Bloom rules and no randomness, so a recorded trace replays bit for bit.
"""

from tpu_gossip_torch.traffic.engine import (
    TRAFFIC_STREAM_SALT,
    StreamTelemetry,
    apply_stream,
    slot_expiry,
)
from tpu_gossip_torch.traffic.ingest import (
    IngestError,
    IngestPlan,
    IngestTelemetry,
    InjectBatch,
    apply_arrivals,
    empty_batch,
    make_batch,
)
from tpu_gossip_torch.traffic.plan import (
    ORIGIN_LAWS,
    CompiledStream,
    StreamError,
    compile_stream,
    default_max_inject,
    min_feasible_ttl,
)

__all__ = [
    "TRAFFIC_STREAM_SALT",
    "StreamTelemetry",
    "apply_stream",
    "slot_expiry",
    "IngestError",
    "IngestPlan",
    "IngestTelemetry",
    "InjectBatch",
    "apply_arrivals",
    "empty_batch",
    "make_batch",
    "ORIGIN_LAWS",
    "CompiledStream",
    "StreamError",
    "compile_stream",
    "default_max_inject",
    "min_feasible_ttl",
]
