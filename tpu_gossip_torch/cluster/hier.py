"""The two-level ICI/DCN transport: the host axis ships compacted.

Ports ``tpu_gossip/cluster/hier.py``. On a (hosts, devices) mesh each
exchange of the sharded engines runs as a dense device stage inside each
host row and a cross-host stage that ships only the occupied rows with an
index plane, or the dense block where the round's gate says the budget
would overflow. Every stage is an exact decomposition of the flat
exchange (rows left out are zero, so the receiver's scatter rebuilds the
dense buffer bit for bit), and no stage draws: a hier round equals the
flat round.

The functions take the shards this process holds stacked along a leading
axis, in flat order (shard ``h * D + d`` is host ``h``, device ``d``): all
S in one process (the fold, whose host stage is a transpose of the stacked
host blocks) or the D of one host row under ``torch.distributed`` (whose
host stage crosses the process group). Both go through the one exchange,
``dist/mesh.py::all_to_all``, over the host axis; the device stage is a
reorder inside the process.

Stage order, as in the JAX package: the bucketed exchange runs the device
stage, then the host stage; the matching transpose runs the host stage
FIRST, then the device stage and one row-block reorder (device-first
would deliver the wrong column slice); its inverse runs the inverse stages
in reverse order, the host stage last. The host stage of a matching pass
compacts on the one gate a pipeline pass reads (``dist/transport.py::
hier_take``): nonzero words are conserved by the stages, so one count
bounds every host stage's occupied rows.
"""

from __future__ import annotations

import torch

__all__ = ["bucketed_hier_exchange", "transpose_pass_hier", "untranspose_pass_hier", "apply_pipeline_hier"]


def _host_a2a(x: torch.Tensor) -> torch.Tensor:
    """The host stage over (Hs_src, H_dst, ...) blocks: (Hs_dst, H_src, ...)."""
    from tpu_gossip_torch.dist.mesh import all_to_all

    return all_to_all(x)


def _compact_host_stage(z: torch.Tensor, cap: int, cols: int | None = None) -> torch.Tensor:
    """The host stage of ``z`` (Hs, H_dst, D, K, W) on the compact lane:
    each (host, destination host, device) row's K-entries with a nonzero
    word among their first ``cols`` columns (all by default) gathered to
    ``cap`` with their index plane, both exchanged, scattered back into the
    (Hs, H_src, D, K, W) buffer the dense stage gives."""
    from tpu_gossip_torch.dist.transport import compact_index, gather_compact, scatter_compact

    hs, h, d, k, w = z.shape
    rows = z.reshape(hs * h * d, k, w)
    idx = compact_index((rows[..., :cols] != 0).any(-1), cap)  # (rows, C), sentinel K
    cvals = gather_compact(rows, idx)
    idx_r = _host_a2a(idx.view(hs, h, d, cap))
    cvals_r = _host_a2a(cvals.view(hs, h, d, cap, w))
    return scatter_compact(idx_r.reshape(-1, cap), cvals_r.reshape(-1, cap, w), k).view(hs, h, d, k, w)


def bucketed_hier_exchange(payload: torch.Tensor, hosts: int, cap: int, fits: bool, words: int | None = None
                           ) -> torch.Tensor:
    """Two-stage twin of the bucketed engine's dense exchange of
    ``payload`` (L, S, B, W), the held shards' destination-major bucket
    blocks. The device stage routes every ``(dst_h, dst_d)`` bucket to
    device ``dst_d`` of the sender's host; each device then holds, per
    destination host, its host's ``D·B`` entries for that host's device:
    the host stage ships them compacted to ``cap`` with an index plane when
    ``fits`` (the replicated pre-activation gate), else dense. An entry
    ships when one of its first ``words`` columns is nonzero (the payload
    words; the merged wire's billing byte alone delivers and bills
    nothing). Returns the received (L, S, B, W), equal to the flat
    exchange's in every delivered word."""
    l, s, b, w = payload.shape
    h = hosts
    d = s // h
    hs = l // d
    # z[hs, dev, dst_h, src_d] = payload[hs, src_d, dst_h, dev]: after the
    # device stage, device ``dev`` holds its host's entries for (dst_h, dev)
    z = payload.view(hs, d, h, d, b, w).permute(0, 3, 2, 1, 4, 5)
    x = z.permute(0, 2, 1, 3, 4, 5).reshape(hs, h, d, d * b, w)  # (Hs, H_dst, D, D·B, W)
    r = _compact_host_stage(x, cap, words) if fits else _host_a2a(x)  # (Hs, H_src, D, D·B, W)
    return r.permute(0, 2, 1, 3, 4).reshape(l, s, b, w).contiguous()


def transpose_pass_hier(x: torch.Tensor, hosts: int, n_shards: int, cap: int, take: bool) -> torch.Tensor:
    """Two-stage twin of ``permute.transpose_pass_sharded`` over the held
    (L, per, 128) blocks. Host stage first: each block's lanes split into
    H pieces, piece ``j`` to host ``j`` (its occupied rows compacted to
    ``cap`` with the index plane when ``take``); then the device stage
    splits the remaining lanes over the host's devices, and one row-block
    reorder restores the flat source-major order before the shared
    transpose-reshape."""
    l, per, _ = x.shape
    h, s = hosts, n_shards
    d = s // h
    hs = l // d
    c = 128 // s
    a = x.view(hs, d, per, h, d * c).permute(0, 3, 1, 2, 4)  # (Hs, H_dst, D, per, 128/H)
    if take:
        sa = _compact_host_stage(a, cap)
    else:
        sa = _host_a2a(a)  # (Hs, H_src, D, per, 128/H)
    # device stage and reorder: out[hs, dst_d, src_h, src_d] = sa[hs, src_h, src_d, :, dst_d]
    out = sa.view(hs, h, d, per, d, c).permute(0, 4, 1, 2, 3, 5).reshape(l, s * per, c)
    return out.transpose(1, 2).reshape(l, per, 128).contiguous()


def untranspose_pass_hier(x: torch.Tensor, hosts: int, n_shards: int, cap: int, take: bool) -> torch.Tensor:
    """Two-stage twin of ``permute.untranspose_pass_sharded``: the inverse
    stages of :func:`transpose_pass_hier` in reverse order, so the host
    stage comes last and compacts per destination host row block."""
    l, per, _ = x.shape
    h, s = hosts, n_shards
    d = s // h
    hs = l // d
    c = 128 // s
    slab = x.view(l, c, s * per).transpose(1, 2)  # (L, S·per, c): rows by destination shard
    # device stage: y[hs, dst_d, dst_h, per, src_d] = slab[hs, src_d, dst_h, dst_d, per]
    y = slab.reshape(hs, d, h, d, per, c).permute(0, 3, 2, 4, 1, 5).reshape(hs, d, h, per, d * c)
    y = y.permute(0, 2, 1, 3, 4)  # (Hs, H_dst, D, per, 128/H)
    r = _compact_host_stage(y, cap) if take else _host_a2a(y)  # (Hs, H_src, D, per, 128/H)
    return r.permute(0, 2, 3, 1, 4).reshape(l, per, 128).contiguous()


def apply_pipeline_hier(x: torch.Tensor, stages: tuple, hosts: int, n_shards: int, per: int, cap: int,
                        take: bool) -> torch.Tensor:
    """``permute.apply_pipeline`` over held (L·per, 128) slot rows with
    every transpose stage run two-level: each lane shuffle stays one K1
    launch over the held rows, each "t"/"tinv" becomes its hier twin, whose
    host stage takes the compact lane on ``take``, the one gate of the
    pass."""
    from tpu_gossip_torch.kernels.permute import lane_shuffle

    r = x.shape[0]
    for stage in stages:
        kind = stage[0]
        if kind == "lane":
            x = lane_shuffle(x.reshape(r, 128), stage[1])
        elif kind == "t":
            x = transpose_pass_hier(x.view(-1, per, 128), hosts, n_shards, cap, take)
        elif kind == "tinv":
            x = untranspose_pass_hier(x.view(-1, per, 128), hosts, n_shards, cap, take)
        else:
            raise ValueError(f"unknown stage kind {kind!r}")
    return x.reshape(r, 128)
