"""SwarmState: the whole gossip swarm as one dataclass of device tensors.

Ports ``ROUND_CAP``, ``saturate_round``, ``SwarmConfig``, ``SwarmState``
(every one of its 25 planes, in the JAX field order, which is the
``state_digest`` leaf order), ``coverage``, ``init_swarm`` (:783) and
``clone_state`` of ``tpu_gossip/core/state.py``. Checkpoint formats, the
plane registry and the batched-lane helpers belong to later slices.

Planes keep the JAX dtypes: bool masks, int16 round-valued planes
saturated at :data:`ROUND_CAP`, int32 ids and counters. The PRNG key is an
int64 (2,) tensor of uint32 words (core/prng.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.topology import Graph
from tpu_gossip_torch.device import resolve_device

__all__ = [
    "ROUND_CAP",
    "saturate_round",
    "SwarmConfig",
    "SwarmState",
    "init_swarm",
    "clone_state",
]

ROUND_CAP = 2**15 - 1


def saturate_round(rnd: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A round cursor narrowed into a round-valued plane: saturated at
    :data:`ROUND_CAP`, cast to ``dtype``."""
    return torch.clamp(rnd, max=ROUND_CAP).to(dtype)


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    """Static protocol parameters (the JAX package's defaults)."""

    n_peers: int
    msg_slots: int = 64
    fanout: int = 3
    hb_period_rounds: int = 3
    timeout_rounds: int = 6
    detect_period_rounds: int = 2
    round_seconds: float = 5.0
    forward_once: bool = False
    sir_recover_rounds: int = 0
    mode: str = "push"
    churn_leave_prob: float = 0.0
    churn_join_prob: float = 0.0
    rewire_slots: int = 0
    rewire_compact_cap: int = 0

    def __post_init__(self):
        if self.n_peers <= 0:
            raise ValueError("n_peers must be positive")
        if self.msg_slots <= 0:
            raise ValueError("msg_slots must be positive")
        if self.mode not in ("push", "push_pull", "flood"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.rewire_compact_cap < 0:
            raise ValueError("rewire_compact_cap must be >= 0")


@dataclasses.dataclass
class SwarmState:
    """Every plane of the swarm. Shapes: N peers, D edge slots, M slots,
    S rewire slots. Field order is the JAX package's."""

    row_ptr: torch.Tensor  # int32 (N+1,)
    col_idx: torch.Tensor  # int32 (D,)
    seen: torch.Tensor  # bool (N, M)
    forwarded: torch.Tensor  # bool (N, M)
    infected_round: torch.Tensor  # int16 (N, M)
    recovered: torch.Tensor  # bool (N, M)
    exists: torch.Tensor  # bool (N,)
    alive: torch.Tensor  # bool (N,)
    silent: torch.Tensor  # bool (N,)
    last_hb: torch.Tensor  # int16 (N,)
    declared_dead: torch.Tensor  # bool (N,)
    rewired: torch.Tensor  # bool (N,)
    rewire_targets: torch.Tensor  # int32 (N, S)
    fault_held: torch.Tensor  # bool (N, M)
    join_round: torch.Tensor  # int16 (N,)
    admitted_by: torch.Tensor  # int32 (N,)
    degree_credit: torch.Tensor  # int32 (N,)
    slot_lease: torch.Tensor  # int16 (M,)
    control_lvl: torch.Tensor  # int32 ()
    pipe_buf: torch.Tensor  # bool (N, M)
    suspect_round: torch.Tensor  # int16 (N,)
    suspect_mark: torch.Tensor  # int16 (N,)
    quarantine: torch.Tensor  # bool (N,)
    rng: torch.Tensor  # int64 (2,) threefry key words
    round: torch.Tensor  # int32 ()

    @property
    def n_peers(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    def coverage(self, slot: int = 0) -> torch.Tensor:
        """Fraction of live peers that have seen message ``slot`` (float32
        ratio of the two counts, as in the JAX package)."""
        live = self.alive & ~self.declared_dead
        n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
        return (self.seen[:, slot] & live).sum().to(torch.float32) / n_live


def init_swarm(
    graph: Graph,
    config: SwarmConfig,
    *,
    key: torch.Tensor | None = None,
    origins=None,
    origin_slot: int = 0,
    origin_slots=None,
    exists: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> SwarmState:
    """Build the swarm state on ``device`` from a graph; infect ``origins``
    in ``origin_slot`` (or each in its own ``origin_slots`` entry)."""
    dev = resolve_device(device)
    if graph.n != config.n_peers:
        raise ValueError(f"graph has {graph.n} nodes but config.n_peers={config.n_peers}")
    if key is None:
        key = prng.key(0, dev)
    n, m = config.n_peers, config.msg_slots
    seen = torch.zeros((n, m), dtype=torch.bool, device=dev)
    infected_round = torch.full((n, m), -1, dtype=torch.int16, device=dev)
    slot_lease = torch.full((m,), -1, dtype=torch.int16, device=dev)
    if origins is not None:
        org = torch.as_tensor(np.asarray(origins), dtype=torch.int64, device=dev)
        if origin_slots is not None:
            slots_host = np.asarray(origin_slots)
            if slots_host.shape != np.asarray(origins).shape:
                raise ValueError(
                    f"origin_slots shape {slots_host.shape} != origins shape "
                    f"{np.asarray(origins).shape}"
                )
            if slots_host.size and (slots_host.min() < 0 or slots_host.max() >= m):
                raise ValueError(f"origin_slots must lie in [0, msg_slots={m})")
            slots = torch.as_tensor(slots_host, dtype=torch.int64, device=dev)
        else:
            slots = torch.full(org.shape, origin_slot, dtype=torch.int64, device=dev)
        seen[org, slots] = True
        infected_round[org, slots] = 0
        slot_lease[slots] = 0
    if exists is None:
        exists = torch.ones((n,), dtype=torch.bool, device=dev)
    exists = torch.as_tensor(exists, device=dev).to(torch.bool).clone()
    s = max(config.rewire_slots, 1)
    return SwarmState(
        row_ptr=torch.as_tensor(graph.row_ptr, device=dev).to(torch.int32).clone(),
        col_idx=torch.as_tensor(graph.col_idx, device=dev).to(torch.int32).clone(),
        seen=seen,
        forwarded=torch.zeros((n, m), dtype=torch.bool, device=dev),
        infected_round=infected_round,
        recovered=torch.zeros((n, m), dtype=torch.bool, device=dev),
        exists=exists,
        alive=exists.clone(),
        silent=torch.zeros((n,), dtype=torch.bool, device=dev),
        last_hb=torch.zeros((n,), dtype=torch.int16, device=dev),
        declared_dead=torch.zeros((n,), dtype=torch.bool, device=dev),
        rewired=torch.zeros((n,), dtype=torch.bool, device=dev),
        rewire_targets=torch.zeros((n, s), dtype=torch.int32, device=dev),
        fault_held=torch.zeros((n, m), dtype=torch.bool, device=dev),
        join_round=torch.where(exists, 0, -1).to(torch.int16),
        admitted_by=torch.full((n,), -1, dtype=torch.int32, device=dev),
        degree_credit=torch.zeros((n,), dtype=torch.int32, device=dev),
        slot_lease=slot_lease,
        control_lvl=torch.tensor(-1, dtype=torch.int32, device=dev),
        pipe_buf=torch.zeros((n, m), dtype=torch.bool, device=dev),
        suspect_round=torch.full((n,), -1, dtype=torch.int16, device=dev),
        suspect_mark=torch.zeros((n,), dtype=torch.int16, device=dev),
        quarantine=torch.zeros((n,), dtype=torch.bool, device=dev),
        rng=key.to(dev).clone(),
        round=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def clone_state(state: SwarmState) -> SwarmState:
    """Deep-copy every plane (a state that outlives its run, e.g. a
    benchmark's input, stays independent of the copy)."""
    return SwarmState(**{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(SwarmState)})
