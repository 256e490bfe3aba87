"""The sparse transport's compaction helpers.

Ports the compaction half of ``tpu_gossip/dist/transport.py`` (:254-306):
the occupancy header and the compact index, gather and scatter that the
sparse lane wraps around each collective. ``utils/profiling.py`` times
their round trip (``transport_compact``). The sparse, auto and
hierarchical transports themselves belong to the multi-device slice.
"""

from __future__ import annotations

import torch

__all__ = ["occupancy_counts", "compact_index", "gather_compact", "scatter_compact"]


def occupancy_counts(occ: torch.Tensor) -> torch.Tensor:
    """The occupancy header: per-destination occupied-entry counts, int32
    (S,) from the (S, B) bool occupancy of one shard's payload."""
    return occ.sum(-1, dtype=torch.int32)


def compact_index(occ: torch.Tensor, cap: int) -> torch.Tensor:
    """Stable compaction index: (S, B) bool -> (S, cap) int32, row s's first
    ``cap`` occupied positions in ascending order, padded with the sentinel
    B. Entries past ``cap`` land in a junk column that is cut off."""
    s, b = occ.shape
    cum = occ.cumsum(1) - 1
    slot = torch.where(occ & (cum < cap), cum, cap)
    idx = torch.full((s, cap + 1), b, dtype=torch.int32, device=occ.device)
    pos = torch.arange(b, dtype=torch.int32, device=occ.device).expand(s, b)
    return idx.scatter_(1, slot, pos)[:, :cap]


def _expand(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(S, C) -> (S, C, *like.shape[2:]) int64, the trailing dims broadcast."""
    return idx.long().view(idx.shape + (1,) * (like.dim() - 2)).expand(idx.shape + like.shape[2:])


def gather_compact(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """payload (S, B, ...) gathered at idx (S, C) -> (S, C, ...); sentinel
    rows gather zeros."""
    b = payload.shape[1]
    vals = torch.gather(payload, 1, _expand(idx.clamp(max=b - 1), payload))
    keep = (idx < b).view(idx.shape + (1,) * (payload.dim() - 2))
    return torch.where(keep, vals, torch.zeros((), dtype=payload.dtype, device=payload.device))


def scatter_compact(idx: torch.Tensor, vals: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`gather_compact`: (S, C, ...) values land at their
    indices in a zero (S, B, ...) buffer; sentinels (== B) drop."""
    s = idx.shape[0]
    out = torch.zeros((s, b + 1) + tuple(vals.shape[2:]), dtype=vals.dtype, device=vals.device)
    return out.scatter_(1, _expand(idx, vals), vals)[:, :b]
