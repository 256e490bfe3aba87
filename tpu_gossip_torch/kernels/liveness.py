"""Heartbeats and the direct failure detector.

Ports ``emit_heartbeats`` (:138) and ``detect_failures`` (:162) of
``tpu_gossip/kernels/liveness.py``: a heartbeat every ``hb_period_rounds``
from live, non-silent, undeclared peers; on sweep rounds a stale peer that
answers its probe refreshes its heartbeat and one that does not is
declared dead. The quorum-suspicion machine and the adversary half of that
module belong to a later slice. Staleness is computed at int32 from the
int16 ``last_hb`` plane.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core.state import saturate_round

__all__ = ["emit_heartbeats", "detect_failures"]


def emit_heartbeats(last_hb: torch.Tensor, alive: torch.Tensor, silent: torch.Tensor,
                    declared_dead: torch.Tensor, rnd: torch.Tensor,
                    hb_period_rounds: int) -> torch.Tensor:
    """Refresh ``last_hb`` for every peer emitting a heartbeat this round."""
    tick = (rnd % hb_period_rounds) == 0
    emit = alive & ~silent & ~declared_dead & tick
    return torch.where(emit, saturate_round(rnd, last_hb.dtype), last_hb)


def detect_failures(last_hb: torch.Tensor, alive: torch.Tensor, silent: torch.Tensor,
                    declared_dead: torch.Tensor, rnd: torch.Tensor, timeout_rounds: int,
                    detect_period_rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One detector sweep; returns ``(last_hb, declared_dead)``."""
    sweep = (rnd % detect_period_rounds) == 0
    stale = (rnd - last_hb.to(torch.int32)) > timeout_rounds
    responsive = alive & ~silent
    new_last = torch.where(sweep & stale & responsive, saturate_round(rnd, last_hb.dtype), last_hb)
    newly_dead = sweep & stale & ~responsive & ~declared_dead
    return new_last, declared_dead | newly_dead
