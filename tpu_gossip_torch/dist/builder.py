"""The distributed matching builder: the sharded layout derived shard by shard.

Ports ``tpu_gossip/dist/builder.py::matching_powerlaw_graph_dist``. Each
shard derives its own table blocks from ``fold_in(stage_key, shard)`` (the
``block_keys=True`` derivation of ``core/matching_topology.py``), its
owner and real-stub planes from the shared ``local_classes``, erases
duplicate edges with a shard-local sort, and exports its own CSR segment
against its own pad-row sentinel. The partner passes run the mesh's
pipeline (``permute.apply_pipeline(..., n_shards=S)``: K1 for the lane
stages, one exchange a transpose), the folds one K2 launch over the
shard-major class table. The result equals
``matching_powerlaw_graph_sharded(n, S, ..., block_keys=True)`` leaf for
leaf.

The shard-local erasure is exact: an edge between u and v has one stub
slot in u's shard and one in v's, and its id ``min(slot, partner slot)``
is the same from both sides, so both shards elect the same keeper among
parallel edges; a shard's rows own exactly its slots' out-edges and its
erased edges absorb into its own pad row, so the global stable CSR sort
is the concatenation of the shard-local ones.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import DeviceGraph
from tpu_gossip_torch.core.matching_topology import (DEG_TABLE_CAP, MatchingPlan, _real_mask, class_layout,
                                                      expand_classes, pipeline_stages, sharded_layout)
from tpu_gossip_torch.kernels.permute import apply_pipeline, inverse_tables

__all__ = ["matching_powerlaw_graph_dist"]


def _sort_perm(*keys: torch.Tensor) -> torch.Tensor:
    """The lexicographic order of ``keys`` (last key primary, as
    ``jnp.lexsort``), by stable argsorts."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def matching_powerlaw_graph_dist(n: int, mesh, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None, *,
                                 fanout: int | None = None, key: torch.Tensor | None = None,
                                 export_csr: bool = True, growth_rows: int = 0) -> tuple[DeviceGraph, MatchingPlan]:
    """The sharded matching swarm built shard by shard on the mesh's
    device; equal to ``matching_powerlaw_graph_sharded(n, mesh.size, ...,
    block_keys=True)`` on every plan leaf and graph array."""
    s = int(mesh.size)
    if s < 1 or 128 % s:
        raise ValueError(f"mesh size {s} must divide 128 (the transpose all_to_all splits the lane axis)")
    if growth_rows < 0:
        raise ValueError(f"growth_rows={growth_rows} must be >= 0")
    dev = mesh.device
    key = prng.key(0, dev) if key is None else key.to(dev)
    lay = sharded_layout(n, s, gamma, d_min, d_max, growth_rows)
    d_max, n_per, local_classes = lay["d_max"], lay["n_per"], lay["local_classes"]
    per_rows, rows, n_blk, n_state, k = lay["per_rows"], lay["rows"], lay["n_blk"], lay["n_state"], lay["n_stages"]
    per_slots = per_rows * 128
    tdt = torch.int8 if lay["int8_tables"] else torch.int32
    narrow = d_max <= DEG_TABLE_CAP
    keys = prng.split(key, k + 1)
    deg_blk = torch.cat([torch.from_numpy(lay["deg_local"]).to(dev),
                         torch.zeros((growth_rows + 1,), dtype=torch.int32, device=dev)])
    local = class_layout(local_classes, per_rows, n_blk, dev)

    # --- each shard's table blocks and plan vectors, from its own draws
    lanes_b, m3_b, owner_b, real_b = [[] for _ in range(k)], [], [], []
    cols = torch.arange(per_rows, device=dev)[:, None]
    for sh in range(s):
        def table(i):
            return torch.argsort(prng.uniform(prng.fold_in(keys[i], sh), (per_rows, 128)), dim=1, stable=True)

        for i in range(k):
            lanes_b[i].append(table(i).to(tdt))
        p = table(k)
        m3 = torch.zeros((per_rows, 128), dtype=torch.int64, device=dev)
        m3[cols, p[:, 0::2]] = p[:, 1::2]
        m3[cols, p[:, 1::2]] = p[:, 0::2]
        m3_b.append(m3.to(tdt))
        owner_b.append(expand_classes(torch.arange(n_blk, dtype=torch.int32, device=dev), local, per_rows)
                       + sh * n_blk)
        real_b.append(_real_mask(deg_blk, local_classes, per_rows))
    lanes = tuple(torch.cat(b) for b in lanes_b)
    m3 = torch.cat(m3_b)
    lanes_inv = tuple(inverse_tables(ln) for ln in lanes)
    stages = pipeline_stages(lanes, m3, lanes_inv)

    def partner(x):
        return apply_pipeline(x, stages, n_shards=s)

    owner, real = torch.cat(owner_b), torch.cat(real_b)
    flat = torch.arange(rows * 128, dtype=torch.int32, device=dev).view(rows, 128)
    part = partner(flat)
    other = partner(owner)
    alive = real & (partner(real.to(torch.int32)) > 0) & (other != owner) & (other < n_state)

    # --- duplicate erasure, one shard-local sort a shard
    cid = torch.minimum(flat, part).view(s, per_slots)
    u = torch.where(alive, owner, n_state).view(s, per_slots)
    v = torch.where(alive, other, n_state).view(s, per_slots)
    dup = torch.zeros((s, per_slots), dtype=torch.bool, device=dev)
    for sh in range(s):
        order = _sort_perm(cid[sh], v[sh], u[sh])
        su, sv = u[sh][order], v[sh][order]
        dup_sorted = torch.zeros_like(su, dtype=torch.bool)
        dup_sorted[1:] = (su[1:] == su[:-1]) & (sv[1:] == sv[:-1]) & (su[1:] != n_state)
        dup[sh][order] = dup_sorted
    dup = dup.view(rows, 128)
    valid = alive & ~(dup | (partner(dup.to(torch.int32)) > 0))

    # --- realized and partner degrees: one fold over the shard-major table
    classes = tuple((sh * n_blk + no, sh * per_slots + so, c, pd, cs)
                    for sh in range(s) for (no, so, c, pd, cs) in local_classes)
    layout = class_layout(classes, rows, n_state, dev)
    plan0 = MatchingPlan(lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid, deg_other=None, n=n_state, rows=rows,
                         classes=classes, layout=layout)
    deg_i32 = plan0.reduce(valid.to(torch.int32), op="sum")
    deg_other = partner(plan0.expand(deg_i32))
    if narrow:
        deg_real = torch.clamp(deg_i32, max=DEG_TABLE_CAP).to(torch.int16)
        deg_other = torch.clamp(deg_other, max=DEG_TABLE_CAP).to(torch.int16)
    else:
        deg_real = deg_i32

    # --- each shard's CSR segment against its own pad-row sentinel
    if export_csr:
        rp_b, col_b = [], []
        valid_f, owner_f, other_f = valid.view(s, per_slots), owner.view(s, per_slots), other.view(s, per_slots)
        for sh in range(s):
            base = sh * n_blk
            src = torch.where(valid_f[sh], owner_f[sh], base + n_blk - 1)
            dst = torch.where(valid_f[sh], other_f[sh], base + n_blk - 1)
            order = torch.argsort(src, stable=True)
            col_b.append(dst[order])
            rows_ix = base + torch.arange(n_blk, dtype=torch.int32, device=dev)
            rp_b.append(sh * per_slots + torch.searchsorted(src[order], rows_ix, side="left").to(torch.int32))
        row_ptr = torch.cat(rp_b + [torch.tensor([rows * 128], dtype=torch.int32, device=dev)])
        col_idx = torch.cat(col_b)
    else:
        totals = deg_i32.view(s, n_blk).sum(1, dtype=torch.int32)
        bases = torch.cumsum(totals, 0, dtype=torch.int32) - totals
        within = torch.cumsum(deg_i32.view(s, n_blk), 1, dtype=torch.int32) - deg_i32.view(s, n_blk)
        row_ptr = torch.cat([(bases[:, None] + within).reshape(-1), totals.sum(dtype=torch.int32).view(1)])
        col_idx = torch.zeros((1,), dtype=torch.int32, device=dev)

    plan = MatchingPlan(
        lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid, deg_other=deg_other, deg_real=deg_real, n=n_state,
        rows=rows, classes=classes, fanout=fanout, mesh_shards=s, n_per=n_per, n_blk=n_blk, per_rows=per_rows,
        local_classes=local_classes, layout=layout,
    )
    exists = torch.from_numpy((np.arange(n_state) % n_blk) < n_per).to(dev)
    return DeviceGraph(row_ptr=row_ptr, col_idx=col_idx, exists=exists, n=n_state - 1), plan
