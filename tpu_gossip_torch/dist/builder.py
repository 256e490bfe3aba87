"""The distributed matching builder: the sharded layout born on its holders.

Ports ``tpu_gossip/dist/builder.py::matching_powerlaw_graph_dist``. A
process builds only the shards it holds (``mesh.lo`` to ``mesh.lo +
mesh.local``: all S in one process, its host row's in a rank of a mesh
over several processes). Each held shard derives its own table blocks
from ``fold_in(stage_key, shard)`` with its global index (the
``block_keys=True`` derivation of ``core/matching_topology.py``), its
owner and real-stub planes from the shared ``local_classes``, erases
duplicate edges with a shard-local sort, and exports its own CSR segment
against its own pad-row sentinel. The partner passes run the mesh's
pipeline over the held blocks (``permute.apply_pipeline(..., n_shards=S,
per=per_rows)``: K1 for the lane stages, one exchange a transpose, which
crosses the process group), the degree fold one K2 launch over the held
class table. No process holds a table of more than its own slot rows.

The result is the held plan, equal to ``shard_matching_plan(
matching_powerlaw_graph_sharded(n, S, ..., block_keys=True)[1], mesh)``
leaf for leaf, and a graph whose ``exists`` is the held rows' and whose
CSR is the whole swarm's: each process's segments, already offset to
their global slots, joined in shard order by an all-gather straight into
the whole array (the row pointers, then the columns). The CSR is
the state's whole field (``dist/mesh.py::_WHOLE_FIELDS``) and the only
whole array the build makes.

The shard-local erasure is exact: an edge between u and v has one stub
slot in u's shard and one in v's, and its id ``min(slot, partner slot)``
is the same from both sides, so both shards elect the same keeper among
parallel edges; a shard's rows own exactly its slots' out-edges and its
erased edges absorb into its own pad row, so the global stable CSR sort
is the concatenation of the shard-local ones.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.cluster.topology import gather_joined
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import DeviceGraph
from tpu_gossip_torch.core.matching_topology import (DEG_TABLE_CAP, MatchingPlan, _real_mask, class_layout,
                                                      expand_classes, pipeline_stages, sharded_layout)
from tpu_gossip_torch.kernels.permute import apply_pipeline, inverse_tables

__all__ = ["matching_powerlaw_graph_dist", "held_classes"]

# the label the CSR's all-gather counts its bytes under (cluster.topology.SIDE_PATHS)
CSR_GATHER = "build csr"


def held_classes(local_classes: tuple, held: int, n_blk: int, per_rows: int) -> tuple:
    """The class table over ``held`` stacked shard blocks: ``local_classes``
    at each block's node and slot offsets."""
    return tuple((j * n_blk + no, j * per_rows * 128 + so, c, pd, cs)
                 for j in range(held) for (no, so, c, pd, cs) in local_classes)


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
    """The sharded matching swarm built on the mesh's device, the held
    shards only: the held plan (equal to ``shard_matching_plan`` of
    ``matching_powerlaw_graph_sharded(n, mesh.size, ..., block_keys=True)``
    on every leaf) and the graph with the whole CSR and the held rows'
    ``exists``."""
    s = int(mesh.size)
    if s < 1 or 128 % s:
        raise ValueError(f"mesh size {s} must divide 128 (the transpose all_to_all splits the lane axis)")
    if growth_rows < 0:
        raise ValueError(f"growth_rows={growth_rows} must be >= 0")
    dev = mesh.device
    lo, held = int(mesh.lo), int(mesh.local)
    key = prng.key(0, dev) if key is None else key.to(dev)
    lay = sharded_layout(n, s, gamma, d_min, d_max, growth_rows)
    d_max, n_per, local_classes = lay["d_max"], lay["n_per"], lay["local_classes"]
    per_rows, rows, n_blk, n_state, k = lay["per_rows"], lay["rows"], lay["n_blk"], lay["n_state"], lay["n_stages"]
    per_slots = per_rows * 128
    tdt = torch.int8 if lay["int8_tables"] else torch.int32
    keys = prng.split(key, k + 1)
    deg_blk = torch.cat([torch.from_numpy(lay["deg_local"]).to(dev),
                         torch.zeros((growth_rows + 1,), dtype=torch.int32, device=dev)])
    local = class_layout(local_classes, per_rows, n_blk, dev)
    mine = range(lo, lo + held)

    # --- each held shard's table blocks and plan vectors, from its own draws
    lanes_b, m3_b, owner_b, real_b = [[] for _ in range(k)], [], [], []
    cols = torch.arange(per_rows, device=dev)[:, None]
    for sh in mine:
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
        return apply_pipeline(x, stages, n_shards=s, per=per_rows)

    owner, real = torch.cat(owner_b), torch.cat(real_b)
    del owner_b, real_b
    flat = torch.arange(lo * per_slots, (lo + held) * per_slots, dtype=torch.int32, device=dev).view(-1, 128)
    cid = torch.minimum(flat, partner(flat)).view(held, per_slots)
    del flat
    other = partner(owner)
    alive = real & (partner(real.to(torch.int32)) > 0) & (other != owner) & (other < n_state)
    del real

    # --- duplicate erasure, one shard-local sort a held shard
    u = torch.where(alive, owner, n_state).view(held, per_slots)
    v = torch.where(alive, other, n_state).view(held, per_slots)
    dup = torch.zeros((held, per_slots), dtype=torch.bool, device=dev)
    for j in range(held):
        order = _sort_perm(cid[j], v[j], u[j])
        su, sv = u[j][order], v[j][order]
        dup_sorted = torch.zeros_like(su, dtype=torch.bool)
        dup_sorted[1:] = (su[1:] == su[:-1]) & (sv[1:] == sv[:-1]) & (su[1:] != n_state)
        dup[j][order] = dup_sorted
        del order, su, sv, dup_sorted
    del cid, u, v
    dup = dup.view(held * per_rows, 128)
    valid = alive & ~(dup | (partner(dup.to(torch.int32)) > 0))
    del alive, dup

    # --- realized and partner degrees: one fold over the held class table
    classes = held_classes(local_classes, held, n_blk, per_rows)
    layout = class_layout(classes, held * per_rows, held * n_blk, dev)
    plan0 = MatchingPlan(lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid, deg_other=None, n=held * n_blk,
                         rows=held * per_rows, classes=classes, layout=layout)
    deg_i32 = plan0.reduce(valid.to(torch.int32), op="sum")
    deg_other = partner(plan0.expand(deg_i32))
    if d_max <= DEG_TABLE_CAP:
        deg_real = torch.clamp(deg_i32, max=DEG_TABLE_CAP).to(torch.int16)
        deg_other = torch.clamp(deg_other, max=DEG_TABLE_CAP).to(torch.int16)
    else:
        deg_real = deg_i32

    # --- each held shard's CSR segment against its own pad-row sentinel,
    # the segments of every process joined in rank order (shard order)
    if export_csr:
        rp_h = torch.empty((held * n_blk,), dtype=torch.int32, device=dev)
        col_h = torch.empty((held * per_slots,), dtype=torch.int32, device=dev)
        valid_f, owner_f = valid.view(held, per_slots), owner.view(held, per_slots)
        other_f = other.view(held, per_slots)
        for j, sh in enumerate(mine):
            base = sh * n_blk
            src = torch.where(valid_f[j], owner_f[j], base + n_blk - 1)
            order = torch.argsort(src, stable=True)
            col_h[j * per_slots: (j + 1) * per_slots] = torch.where(valid_f[j], other_f[j], base + n_blk - 1)[order]
            rows_ix = base + torch.arange(n_blk, dtype=torch.int32, device=dev)
            rp_h[j * n_blk: (j + 1) * n_blk] = sh * per_slots + torch.searchsorted(src[order], rows_ix, side="left")
            del src, order
        del owner, other, valid_f, owner_f, other_f
        row_ptr = torch.cat([gather_joined(rp_h, label=CSR_GATHER),
                             torch.tensor([rows * 128], dtype=torch.int32, device=dev)])
        del rp_h
        col_idx = gather_joined(col_h, label=CSR_GATHER)
        del col_h
    else:
        deg_all = gather_joined(deg_i32, label=CSR_GATHER)
        totals = deg_all.view(s, n_blk).sum(1, dtype=torch.int32)
        bases = torch.cumsum(totals, 0, dtype=torch.int32) - totals
        within = torch.cumsum(deg_all.view(s, n_blk), 1, dtype=torch.int32) - deg_all.view(s, n_blk)
        row_ptr = torch.cat([(bases[:, None] + within).reshape(-1), totals.sum(dtype=torch.int32).view(1)])
        col_idx = torch.zeros((1,), dtype=torch.int32, device=dev)

    plan = MatchingPlan(
        lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid, deg_other=deg_other, deg_real=deg_real,
        n=held * n_blk, rows=held * per_rows, classes=classes, fanout=fanout, mesh_shards=s, n_per=n_per,
        n_blk=n_blk, per_rows=per_rows, local_classes=local_classes, layout=layout, shard_lo=lo,
    )
    exists = (torch.arange(lo * n_blk, (lo + held) * n_blk, device=dev) % n_blk) < n_per
    return DeviceGraph(row_ptr=row_ptr, col_idx=col_idx, exists=exists, n=n_state - 1), plan
