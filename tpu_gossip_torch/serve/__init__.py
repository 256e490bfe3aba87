"""Live ingestion frontend: serve the reference wire protocol from the swarm
on the card.

Ports ``tpu_gossip/serve/``:

- ``serve/protocol.py``: the total parse of one inbound line into a typed
  event, the stable 64-bit payload hash that maps a gossip line to its dedup
  slots, the ``QUERY`` extension;
- ``serve/frontend.py``: an asyncio socket frontend on its own thread,
  accepting many concurrent clients, mapping each to a state row and
  batching each round window's arrivals (FIFO, overflow carried and billed,
  never dropped);
- ``serve/driver.py``: the round driver, one step a run (local engine,
  packed included, or the sharded matching mesh), overlapping the host's
  window work with the card's round through CUDA events;
- ``serve/trace.py``: the ``(round, origin, payload_hash)`` trace, in the
  JAX package's JSONL format, whose replay is bit-identical to the live run
  in either package;
- ``serve/loadgen.py``: the scripted multi-client load generator.
"""

from tpu_gossip_torch.serve.driver import DriverReport, ServeDriver, build_step, stack_round_stats
from tpu_gossip_torch.serve.frontend import FrontendCounters, ServeFrontend, origin_for_addr
from tpu_gossip_torch.serve.loadgen import LoadReport, run_load
from tpu_gossip_torch.serve.protocol import ServeEvent, parse_line, payload_hash64, slots_for_payload
from tpu_gossip_torch.serve.trace import ServeTrace, TraceRecorder, replay_trace

__all__ = [
    "DriverReport",
    "FrontendCounters",
    "LoadReport",
    "ServeDriver",
    "ServeEvent",
    "ServeFrontend",
    "ServeTrace",
    "TraceRecorder",
    "build_step",
    "origin_for_addr",
    "parse_line",
    "payload_hash64",
    "replay_trace",
    "run_load",
    "slots_for_payload",
    "stack_round_stats",
]
