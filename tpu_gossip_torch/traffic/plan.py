"""Streaming workload plans: arrival process and origin law, compiled on the host.

Ports ``tpu_gossip/traffic/plan.py``. A :class:`CompiledStream` describes
a sustained message stream for one engine's row layout:

- **arrival process**: Poisson(``rate``) arrivals a round; with
  ``burst_every > 0`` every ``burst_every``-th round draws at ``rate *
  burst_mult``. Arrivals past the static ``max_inject`` batch are dropped
  that round (sized to the peak rate's +6 sigma tail by default);
- **origin law**: ``uniform`` over the initial membership
  (``origin_rows``), ``degree`` (a uniform index into the CSR endpoint
  list) or ``hotspot`` (a uniform draw mixed with one over the ``hot_n``
  lowest peer ids at weight ``hot_weight``);
- **slot law**: ``k_hashes`` uniform slots a message; k = 1 conflates on a
  live slot, k >= 2 suppresses a message whose every slot is leased.

``origin_rows`` is the id-ordered table of real peer rows, so a local and
a bucketed run sharing a layout draw the same origins.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device

__all__ = [
    "StreamError",
    "CompiledStream",
    "compile_stream",
    "default_max_inject",
    "min_feasible_ttl",
    "ORIGIN_LAWS",
]

ORIGIN_LAWS = ("uniform", "degree", "hotspot")


class StreamError(ValueError):
    """A streaming config that cannot mean what it says (compile time)."""


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledStream:
    """A streaming workload compiled to device tables.

    ``rate`` is the float32 mean arrivals a round, on the device and, as
    ``rate_f32``, on the host, where the round's burst and Poisson branch
    are decided; the ints and strings fix the batch shape, the origin law
    and the Bloom width. A zero-rate stream still ages leases out and
    otherwise leaves the run as it was."""

    rate: torch.Tensor  # f32 0-d
    origin_rows: torch.Tensor  # int32 (n_real,): id-ordered real-peer rows
    hot_rows: torch.Tensor  # int32 (hot_n,): hotspot origin rows (one zero if unused)
    ttl: int
    max_inject: int
    k_hashes: int
    origins: str
    hot_weight: float
    burst_every: int
    burst_mult: float
    rate_f32: float


def default_max_inject(peak_rate: float) -> int:
    """The static arrival batch a peak Poisson rate needs: the +6 sigma
    tail makes a dropped arrival a <1e-8 event a round."""
    return max(int(math.ceil(peak_rate + 6.0 * math.sqrt(max(peak_rate, 1.0)))), 4)


def min_feasible_ttl(n_peers: int, fanout: int, mode: str = "push") -> int:
    """The shortest slot TTL that can plausibly cover the swarm:
    ``ceil(log_{max(2, 1 + fanout)} n) + 4`` rounds."""
    growth_rate = max(2, 1 + max(fanout, 1))
    return int(math.ceil(math.log(max(n_peers, 2)) / math.log(growth_rate))) + 4


def compile_stream(
    *,
    rate: float,
    msg_slots: int,
    ttl: int,
    origin_rows: np.ndarray,
    origins: str = "uniform",
    k_hashes: int = 1,
    hot_frac: float = 0.01,
    hot_weight: float = 0.9,
    burst_every: int = 0,
    burst_mult: float = 4.0,
    max_inject: int | None = None,
    device: str | torch.device = "cuda",
) -> CompiledStream:
    """Compile a streaming workload for one engine's slot layout on
    ``device``. ``origin_rows`` lists the real peer state rows in peer-id
    order; an impossible workload raises :class:`StreamError` with the
    JAX words."""
    if rate < 0:
        raise StreamError(f"injection rate {rate} must be >= 0")
    if ttl < 1:
        raise StreamError(f"slot TTL {ttl} must be >= 1 round")
    if not (1 <= k_hashes <= msg_slots):
        raise StreamError(
            f"k_hashes={k_hashes} outside [1, msg_slots={msg_slots}] — the "
            "Bloom planes live in the slot dimension"
        )
    if origins not in ORIGIN_LAWS:
        raise StreamError(f"unknown origin law {origins!r}; choose from {ORIGIN_LAWS}")
    if burst_every < 0 or burst_mult <= 0:
        raise StreamError("burst_every must be >= 0 and burst_mult > 0")
    origin_rows = np.asarray(origin_rows, dtype=np.int64)
    if origin_rows.ndim != 1 or origin_rows.size == 0:
        raise StreamError("origin_rows must be a non-empty 1-D row table")
    peak = rate * (burst_mult if burst_every > 0 else 1.0)
    if max_inject is None:
        max_inject = default_max_inject(peak)
    if max_inject < 1:
        raise StreamError(f"max_inject={max_inject} must be >= 1")
    if not (0.0 <= hot_weight <= 1.0):
        raise StreamError(f"hot_weight={hot_weight} outside [0, 1]")
    if origins == "hotspot":
        if not (0.0 < hot_frac <= 1.0):
            raise StreamError(f"hot_frac={hot_frac} outside (0, 1]")
        hot_n = max(1, int(hot_frac * origin_rows.size))
        hot_rows = origin_rows[:hot_n]  # lowest peer ids = the hubs
    else:
        hot_rows = np.zeros(1, dtype=np.int64)
    dev = resolve_device(device)
    return CompiledStream(
        rate=torch.tensor(rate, dtype=torch.float32, device=dev),
        origin_rows=torch.from_numpy(origin_rows.astype(np.int32)).to(dev),
        hot_rows=torch.from_numpy(hot_rows.astype(np.int32)).to(dev),
        ttl=int(ttl),
        max_inject=int(max_inject),
        k_hashes=int(k_hashes),
        origins=str(origins),
        hot_weight=float(hot_weight),
        burst_every=int(burst_every),
        burst_mult=float(burst_mult),
        rate_f32=float(np.float32(rate)),
    )
