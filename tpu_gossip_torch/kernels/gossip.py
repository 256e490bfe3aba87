"""Exactly-k gossip delivery over the CSR: gathers and scatters in plain torch.

Ports ``tpu_gossip/kernels/gossip.py``: ``edge_sources`` (:32),
``sample_fanout_targets`` (:44), ``push_fanout`` (:69), ``pull_fanout``
(:90) and ``flood_all`` (:102). The JAX package leaves these to XLA, outside
any Pallas kernel, so here they stay torch operations. A boolean
scatter-max is an OR, so ``push_fanout`` and ``flood_all`` count hits with
``index_add_`` and test them against zero: exact in any order.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import repeat_ids

__all__ = ["edge_sources", "sample_fanout_targets", "push_fanout", "pull_fanout", "flood_all"]


def edge_sources(row_ptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Row (source peer) id of every CSR entry, int32 (num_edges,); entries
    past ``row_ptr[-1]`` (capacity padding) read the last row."""
    return repeat_ids(row_ptr[1:] - row_ptr[:-1], num_edges)


def sample_fanout_targets(key: torch.Tensor, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                          fanout: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``fanout`` uniform neighbours per peer, with replacement: int32 (N, K)
    ids and a bool (N, K) mask (False for peers without neighbours). The
    offset is ``trunc(u * deg)`` in float32, as the JAX package draws it."""
    n = row_ptr.shape[0] - 1
    deg = (row_ptr[1:] - row_ptr[:-1])[:, None]
    if col_idx.shape[0] == 0:
        return (torch.zeros((n, fanout), dtype=torch.int32, device=row_ptr.device),
                torch.zeros((n, fanout), dtype=torch.bool, device=row_ptr.device))
    u = prng.uniform(key, (n, fanout))
    off = torch.minimum((u * deg.to(torch.float32)).to(torch.int32), deg - 1)
    idx = torch.clamp(row_ptr[:-1, None] + off, 0, col_idx.shape[0] - 1)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    return col_idx[idx.to(torch.int64)], (deg > 0).expand(n, fanout)


def push_fanout(transmit: torch.Tensor, targets: torch.Tensor, push_valid: torch.Tensor,
                n_out: int | None = None) -> torch.Tensor:
    """Scatter-OR each sender's (N, M) bitmap into its sampled targets;
    returns the delivered (n_out, M) bool, ``n_out`` the senders' N unless
    the targets index a wider row space."""
    n, m = transmit.shape
    payload = (transmit[:, None, :] & push_valid[:, :, None]).reshape(-1, m)
    hits = torch.zeros((n if n_out is None else n_out, m), dtype=torch.int32, device=transmit.device)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    hits.index_add_(0, targets.reshape(-1).to(torch.int64), payload.to(torch.int32))
    return hits > 0


def pull_fanout(transmit: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gather-OR from each peer's sampled neighbours; (N, M) bool."""
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    got = transmit[targets.to(torch.int64)] & valid[:, :, None]
    return got.any(dim=1)


def flood_all(transmit: torch.Tensor, row_ptr: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """``incoming[i] = OR over j in N(i) of transmit[j]``: an edge gather
    and a segment OR by row. Slots past ``row_ptr[-1]`` (capacity padding)
    carry nothing."""
    n = row_ptr.shape[0] - 1
    d = col_idx.shape[0]
    if d == 0:
        return torch.zeros_like(transmit)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    src = edge_sources(row_ptr, d).to(torch.int64)
    real = torch.arange(d, device=col_idx.device) < row_ptr[-1]
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    vals = transmit[col_idx.to(torch.int64)] & real[:, None]
    hits = torch.zeros((n, transmit.shape[1]), dtype=torch.int32, device=transmit.device)
    hits.index_add_(0, src, vals.to(torch.int32))
    return hits > 0
