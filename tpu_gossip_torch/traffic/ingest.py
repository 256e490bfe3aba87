"""Deterministic arrival injection: the serving frontend's device half.

Ports ``tpu_gossip/traffic/ingest.py``. The streaming plane
(``apply_stream``) synthesizes traffic from a PRNG stream; the serving
plane (``serve/``) receives real traffic over sockets: the host frontend
batches each round window's accepted arrivals into an :class:`InjectBatch`
and :func:`apply_arrivals` lands them with the streaming engine's
per-message semantics (the sequential landing over the lease table, k = 1
conflation or k >= 2 Bloom suppression, the bits set after the tail) and
no randomness: origins and slots are data. Replaying a recorded sequence
of batches therefore reproduces the live run bit for bit
(``serve/trace.py``), and a zero-count batch is bit-identical to
``inject=None``.

The batch keeps JAX's static shape (``max_inject`` rows, entries past
``count`` dead) on the device, and its ``count`` and ``overflow`` as host
ints: the landing runs ``count`` steps (``traffic/engine.py::
land_arrivals``, a handful of (M,)-sized launches each) and reads nothing
back from the card, so a served round never waits on the device. Arrivals
beyond ``max_inject`` in one window are never dropped: the frontend carries
them into the next window and bills them to ``overflow``
(``RoundStats.ingest_overflow``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_gossip_torch.core.state import message_slots
from tpu_gossip_torch.traffic.engine import land_arrivals, scatter_arrivals

__all__ = [
    "IngestError",
    "IngestPlan",
    "InjectBatch",
    "IngestTelemetry",
    "empty_batch",
    "make_batch",
    "apply_arrivals",
]


class IngestError(ValueError):
    """An ingest config that cannot mean what it says."""


@dataclasses.dataclass(frozen=True)
class IngestPlan:
    """The static shape between the host frontend and the device stage:
    every round's batch is ``(max_inject,)`` origins by ``(max_inject,
    k_hashes)`` slots. ``k_hashes`` follows the streaming plane's Bloom
    semantics (k = 1 conflates on a live lease, k >= 2 suppresses only when
    all k slots are leased)."""

    msg_slots: int
    max_inject: int
    k_hashes: int = 1

    def __post_init__(self):
        if self.max_inject < 1:
            raise IngestError(f"max_inject={self.max_inject} must be >= 1")
        if not (1 <= self.k_hashes <= self.msg_slots):
            raise IngestError(
                f"k_hashes={self.k_hashes} outside [1, msg_slots="
                f"{self.msg_slots}] — the Bloom planes live in the slot "
                "dimension"
            )


class InjectBatch(NamedTuple):
    """One round window's accepted arrivals.

    ``origins`` are state rows (sharded callers map peer ids through their
    layout first), ``slots`` each message's ``k`` hash slots
    (:func:`~tpu_gossip_torch.core.state.message_slots` of the payload
    hash), both int32 on the round's device; entries at index >= ``count``
    are dead padding. ``count`` and ``overflow`` (arrivals the window
    could not fit, carried to the next batch) are host ints.
    """

    origins: torch.Tensor  # (j,) int32
    slots: torch.Tensor  # (j, k) int32
    count: int
    overflow: int


class IngestTelemetry(NamedTuple):
    """Per-round ingest counters for RoundStats (all 0-d int32)."""

    offered: torch.Tensor  # arrivals presented to the device this round
    injected: torch.Tensor  # arrivals that landed (live origin, not suppressed)
    conflated: torch.Tensor  # k=1: landed on a live lease; k>=2: suppressed
    overflow: torch.Tensor  # arrivals deferred past this round's window


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` on ``device``: from pinned host memory without a wait on the
    card (the caching host allocator keeps the buffer until the copy ran)."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def empty_batch(plan: IngestPlan, device="cuda") -> InjectBatch:
    """The zero-arrival batch: landing it is bit-identical to ``inject=None``."""
    j, k = plan.max_inject, plan.k_hashes
    return InjectBatch(origins=torch.zeros((j,), dtype=torch.int32, device=device),
                       slots=torch.zeros((j, k), dtype=torch.int32, device=device), count=0, overflow=0)


def make_batch(plan: IngestPlan, origins, payload_hashes, *, overflow: int = 0, device="cuda") -> InjectBatch:
    """Pad ``origins`` and ``payload_hashes`` (one per accepted arrival, in
    arrival order: the landing is sequential, so order is part of the
    trace) to the plan's static shape on ``device``. Callers with more than
    ``max_inject`` arrivals carry the excess into the next window and bill
    it here as ``overflow``."""
    origins = np.asarray(origins, dtype=np.int64)
    hashes = list(payload_hashes)
    if origins.ndim != 1 or origins.shape[0] != len(hashes):
        raise IngestError(
            f"origins {origins.shape} and payload_hashes ({len(hashes)}) "
            "must be parallel 1-D sequences"
        )
    n_arr = origins.shape[0]
    if n_arr > plan.max_inject:
        raise IngestError(
            f"{n_arr} arrivals exceed max_inject={plan.max_inject}; carry "
            "the excess into the next window and bill it as overflow="
        )
    j, k = plan.max_inject, plan.k_hashes
    o = np.zeros(j, dtype=np.int32)
    o[:n_arr] = origins
    s = np.zeros((j, k), dtype=np.int32)
    for i, h in enumerate(hashes):
        s[i] = message_slots(h, plan.msg_slots, k)
    return InjectBatch(origins=_to_device(o, device), slots=_to_device(s, device), count=int(n_arr),
                       overflow=int(overflow))


def apply_arrivals(batch: InjectBatch, rnd: torch.Tensor, *, seen, infected_round, slot_lease, exists, alive,
                   declared_dead):
    """Land one round window's arrivals; returns ``(seen, infected_round,
    slot_lease, telemetry)``.

    The deterministic twin of ``apply_stream``'s landing half: the same
    sequential lease scan, the same conflation and Bloom rules, the same
    saturated int16 lease writes, with the draws replaced by the batch's
    data. Consumes no randomness, so composing it with any stochastic plane
    moves no stream. Runs after the tail and the row stages: an origin is
    gated on the round's final liveness (``exists & alive &
    ~declared_dead``, a client whose peer is down is offered, not
    injected), and a round-r arrival first transmits in round r + 1."""
    n = exists.shape[0]
    dev = seen.device
    c = batch.count
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    landed = conflated = zero
    if c:
        safe_o = torch.clamp(batch.origins[:c].to(torch.int64), 0, n - 1)
        ok = exists[safe_o] & alive[safe_o] & ~declared_dead[safe_o]
        slots = batch.slots[:c].to(torch.int64)
        slot_lease, landed, conflated = land_arrivals(slot_lease, slots, ok, rnd, batch.slots.shape[1])
        seen, infected_round = scatter_arrivals(seen, infected_round, safe_o, slots, landed, rnd)
        landed, conflated = landed.sum(dtype=torch.int32), conflated.sum(dtype=torch.int32)
    telem = IngestTelemetry(offered=torch.full((), c, dtype=torch.int32, device=dev), injected=landed,
                            conflated=conflated,
                            # graftlint: disable=round-host-sync -- the serving window's overflow count is a host value
                            overflow=torch.full((), int(batch.overflow), dtype=torch.int32, device=dev))
    return seen, infected_round, slot_lease, telem
