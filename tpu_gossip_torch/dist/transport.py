"""The sparsity-adaptive transport of the sharded exchanges.

Ports ``tpu_gossip/dist/transport.py``: the occupancy header, the compact
index, gather and scatter around each exchange, the bucketed engine's
compact lane (``build_transport`` of a ``ShardedGraph``), the matching
family's hub/leaf transpose lanes
(:func:`transpose_pass_sparse`, :func:`untranspose_pass_sparse`, chosen
stage by stage by :meth:`Transport.gates` and :meth:`Transport.lanes`)
and the analytic ICI word counters (:class:`IciRound`,
:func:`ici_round_bucketed`, :func:`ici_round_matching`).

The transport reorders bytes and never draws: a compact lane rebuilds the
exact dense buffer the dense lane would have produced, so a sparse or
auto round equals the dense one bit for bit. A lane is taken when the
header proves the compact budget holds on every shard (the JAX package's
``lax.cond``; here the gate is read on the host, once an exchange or a
pipeline pass). The port's matching pipeline moves 32-slot int32 words,
so its gate counts nonzero words of that plane; the counters are the JAX
package's analytic model of its byte-plane wire, integer for integer, and
describe JAX's lane choices, not the port's. The port's own choices are
counted apart (:func:`lane_counts`: transpose stages run compact and
dense since :func:`reset_lane_counts`).

The two-level ``hier`` transport (``build_transport(..., "hier",
hosts=H)``) runs each exchange of a (hosts, devices) mesh as a dense
device stage and a compacted host stage (``cluster/hier.py``); the
counters bill the host stage to the ``dcn_*`` columns as the JAX package
bills it. On a process of a multi-process mesh the counters and the gates
read the whole swarm: each process's counts are summed or maximised over
the processes (``cluster/topology.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Transport",
    "IciRound",
    "IciTotals",
    "ICI_TOTALS_RADIX",
    "accumulate_ici",
    "zero_ici",
    "zero_ici_totals",
    "build_transport",
    "bucketed_dense_exchange_words",
    "matching_dense_stage_words",
    "occupancy_counts",
    "header_spec",
    "compact_index",
    "gather_compact",
    "scatter_compact",
    "transpose_pass_sparse",
    "untranspose_pass_sparse",
    "lane_counts",
    "reset_lane_counts",
    "hier_take",
    "ici_round_bucketed",
    "ici_round_matching",
]

# the matching pipeline's transpose stages as the port ran them: compact
# lane or dense pass, summed over every gated pipeline pass
_LANES = {"compact": 0, "dense": 0}


def lane_counts() -> dict:
    """The port's own lane choices since :func:`reset_lane_counts` (the
    ``IciRound`` counters model the JAX package's byte-plane wire)."""
    return dict(_LANES)


def reset_lane_counts() -> None:
    for k in _LANES:
        _LANES[k] = 0


@dataclasses.dataclass(frozen=True)
class Transport:
    """Static routing state of the sparsity-adaptive exchange (the JAX
    field order). ``budget`` is the compact lane's static worst-case entry
    count (bucket entries, or slot rows for the matching family);
    ``active`` the static half of the auto gate. The matching tables:
    ``leaf_slots`` (R, 128) bool marks stage-0 slots of leaf classes and
    ``hub_tables[k]`` is transpose stage k's (S, H_k) int32 hub-row table
    (send-local rows for "t" stages, global rows for "tinv", padded with
    the out-of-range sentinel); ``stage_mode[k]`` is "hub", "plain" or
    "dense". A ``hier`` transport carries ``hosts``, the host rows it was
    built for, and ``dcn_budget``, its host stage's compact budget (bucket
    entries, or slot rows for the matching family). ``shard_lo`` is the
    first shard this process holds (0 but on a multi-process mesh): the
    matching compact lanes read their hub rows from there on."""

    leaf_slots: torch.Tensor | None = None
    hub_tables: tuple = ()
    engine: str = "bucketed"
    mode: str = "sparse"
    active: bool = True
    budget: int = 0
    stage_mode: tuple = ()
    hub_degree_min: int = 0
    n_shards: int = 1
    fingerprint: int = 0
    hosts: int = 1
    dcn_budget: int = 0
    shard_lo: int = 0

    @property
    def hier(self) -> bool:
        return self.mode == "hier"

    def check_hosts(self, mesh) -> None:
        """A hier transport runs on a mesh of the host rows it was built for."""
        if self.hier and self.hosts != mesh.hosts:
            what = "sg" if self.engine == "bucketed" else "plan"
            raise ValueError(f"hier transport built for {self.hosts} hosts but the mesh has {mesh.hosts} host rows — "
                             f"rebuild with build_transport({what}, 'hier', hosts={mesh.hosts})")

    def check_matches_graph(self, sg) -> None:
        if self.engine != "bucketed":
            raise ValueError("transport built for the matching family cannot drive the bucketed exchange — "
                             "build_transport(sg) for this graph")
        got, want = (self.n_shards, self.fingerprint), (sg.n_shards, sg.fingerprint)
        if got != want:
            raise ValueError(f"transport built for (shards, fingerprint)={got} but the graph has {want} — rebuild "
                             "with build_transport(sg) (repartitioned graphs route differently)")

    def gates(self, x: torch.Tensor) -> tuple[bool, bool]:
        """The occupancy header of one (R, 128) int32 pipeline plane:
        whether its leaf-origin and its total nonzero word counts fit the
        budget (both conserved by the permutation, so they bound every
        stage's compact occupancy)."""
        from tpu_gossip_torch.cluster.topology import reduce_sum

        nz = x != 0
        total, leaf_words = reduce_sum(torch.stack([nz.sum(), (nz & self.leaf_slots).sum()])).tolist()
        return leaf_words <= self.budget, total <= self.budget

    def lanes(self, take_leaf: bool, take_total: bool) -> tuple:
        """Per transpose stage, the compact lane the gates admit (a "hub"
        stage on ``take_leaf``, a "plain" one on ``take_total``) or None,
        the dense pass: ``permute.apply_pipeline(..., lanes=)``."""
        out = []
        for tbl, mode in zip(self.hub_tables, self.stage_mode):
            take = mode != "dense" and (take_leaf if mode == "hub" else take_total)
            _LANES["compact" if take else "dense"] += 1
            out.append(functools.partial(_sparse_pass, table=tbl, cap=self.budget, n_shards=self.n_shards,
                                         lo=self.shard_lo)
                       if take else None)
        return tuple(out)

    def check_matches_plan(self, plan) -> None:
        """Layout check only (shards, rows), as the JAX package's: pair the
        transport with the plan it was built from."""
        if self.engine != "matching":
            raise ValueError("transport built for the bucketed engine cannot drive the matching transposes — "
                             "build_transport(plan) for this plan")
        got, want = (self.n_shards, self.fingerprint), (plan.mesh_shards, plan.mesh_shards * plan.per_rows)
        if got != want:
            raise ValueError(f"transport built for (shards, rows)={got} but the plan has {want} — rebuild with "
                             "build_transport(plan)")


class IciRound(NamedTuple):
    """One round's analytic wire accounting in 4-byte words (int64 0-d
    tensors; the JAX package's int32 values). ``dense_words`` is what the
    dense transport ships, ``shipped_words`` what the configured one ships
    (compact lanes and headers where the gate takes them), ``occupied_words``
    the realized nonzero payload words; ``sparse_lanes``/``total_lanes``
    count gated exchanges taking the compact lane. The ``dcn_*`` columns,
    the slice crossing a host axis, are zero on the one-host mesh."""

    dense_words: torch.Tensor
    shipped_words: torch.Tensor
    occupied_words: torch.Tensor
    sparse_lanes: torch.Tensor
    total_lanes: torch.Tensor
    dcn_dense_words: torch.Tensor
    dcn_shipped_words: torch.Tensor


def _i(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def zero_ici(device=None) -> IciRound:
    z = _i(0, device)
    return IciRound(z, z, z, z, z, z, z)


def _add_ici(a: IciRound, b: IciRound) -> IciRound:
    return IciRound(*(x + y for x, y in zip(a, b)))


# the JAX package carries run totals as a hi/lo int32 pair in this radix
ICI_TOTALS_RADIX = 1 << 27


class IciTotals(NamedTuple):
    """ICI word totals over a run to coverage (hi/lo pairs, radix
    :data:`ICI_TOTALS_RADIX`, as the JAX package's while-loop carry holds
    them); :meth:`words` reads them as python ints."""

    hi: IciRound
    lo: IciRound

    def words(self) -> dict:
        return {f: int(getattr(self.hi, f)) * ICI_TOTALS_RADIX + int(getattr(self.lo, f))
                for f in IciRound._fields}


def zero_ici_totals(device=None) -> IciTotals:
    return IciTotals(zero_ici(device), zero_ici(device))


def accumulate_ici(tot: IciTotals, ici: IciRound) -> IciTotals:
    """Fold one round's counters into the hi/lo totals."""
    lo = _add_ici(tot.lo, ici)
    hi = IciRound(*(h + (lv >> 27) for h, lv in zip(tot.hi, lo)))
    return IciTotals(hi, IciRound(*(lv & (ICI_TOTALS_RADIX - 1) for lv in lo)))


def occupancy_counts(occ: torch.Tensor) -> torch.Tensor:
    """The occupancy header: per-destination occupied-entry counts, int32
    (S,) from the (S, B) bool occupancy of one shard's payload."""
    return occ.sum(-1, dtype=torch.int32)


def header_spec(n_shards: int) -> tuple:
    """Declared (shape, dtype) of one shard's occupancy header row."""
    return (n_shards,), torch.int32


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
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
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


# --------------------------------------------- matching transpose lanes


def _rows_at(x: torch.Tensor, ix: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Rows ``ix`` (S, K) of each stacked block of ``x`` (S, B, w), zeros
    where ``ix >= sentinel``: one gather over ``x`` and a zero row."""
    s, b, w = x.shape
    xpad = torch.cat([x, x.new_zeros((s, 1, w))], dim=1)
    ix = torch.where(ix < sentinel, ix.long(), b)
    return torch.gather(xpad, 1, ix.unsqueeze(-1).expand(s, ix.shape[1], w))


def transpose_pass_sparse(x: torch.Tensor, n_shards: int, hub_table: torch.Tensor, cap: int,
                          lo: int = 0) -> torch.Tensor:
    """Compacted twin of ``permute.transpose_pass_sharded`` over the held
    (L, per, 128) blocks, shards ``lo`` on: each shard sends its hub rows
    (``hub_table[s]``, local rows, sentinel ``per``) and its occupied leaf
    rows compacted to ``cap`` with an index plane, lane piece by lane
    piece; each receiver scatters the pieces into its (R, 128/S) lane slab
    (rows nobody sent were zero) and finishes with the dense lane's
    transpose-reshape."""
    from tpu_gossip_torch.dist.mesh import all_to_all

    l, per, _ = x.shape
    s = n_shards
    w, r, dev = 128 // s, per * s, x.device
    hub_all = hub_table.to(dev).long()
    hub = hub_all[lo: lo + l]
    hub_mask = torch.zeros((l, per + 1), dtype=torch.bool, device=dev)
    hub_mask.scatter_(1, hub.clamp(max=per), True)
    occ = (x != 0).any(-1) & ~hub_mask[:, :per]
    idx = compact_index(occ, cap)  # (L, C) local rows, sentinel per
    send = _rows_at(x, torch.cat([hub, idx.long()], dim=1), per)  # (L, H+C, 128)
    pieces = all_to_all(send.view(l, -1, s, w).transpose(1, 2))  # (L_dst, S_src, H+C, w)
    # every source's index plane, as each receiver reads it
    idx_all = idx if l == s else all_to_all(idx[:, None, :].expand(l, s, cap))[0]  # (S_src, C)
    off = (torch.arange(s, dtype=torch.int64, device=dev) * per)[:, None]
    rows = torch.cat([torch.where(hub_all < per, hub_all + off, r),
                      torch.where(idx_all < per, idx_all.long() + off, r)], dim=1)
    slab = torch.zeros((l, r + 1, w), dtype=x.dtype, device=dev)
    slab[:, rows.reshape(-1)] = pieces.reshape(l, -1, w)
    return slab[:, :r].transpose(1, 2).reshape(l, per, 128)


def untranspose_pass_sparse(x: torch.Tensor, n_shards: int, hub_table: torch.Tensor, cap: int,
                            lo: int = 0) -> torch.Tensor:
    """Compacted twin of ``permute.untranspose_pass_sharded`` over the held
    blocks, shards ``lo`` on: each shard's (R, 128/S) lane slab of the output
    ships its hub rows (``hub_table``: GLOBAL output rows grouped by
    destination shard, sentinel R) densely and each destination's occupied
    leaf rows compacted to ``cap`` with a per-destination index plane; each receiver rebuilds its (per, 128)
    block lane slab by lane slab."""
    from tpu_gossip_torch.dist.mesh import all_to_all

    l, per, _ = x.shape
    s = n_shards
    w, r, dev = 128 // s, per * s, x.device
    hub = hub_table.to(dev).long()
    h = hub.shape[1]
    slab = x.view(l, w, r).transpose(1, 2)  # (L, R, w)
    hub_mask = torch.zeros((r + 1,), dtype=torch.bool, device=dev)
    hub_mask[hub.reshape(-1)] = True
    occ = ((slab != 0).any(-1) & ~hub_mask[:r]).view(l * s, per)
    idx = compact_index(occ, cap).view(l, s, cap)  # (L_src, S_dst, C) destination-local, sentinel per
    off = (torch.arange(s, dtype=torch.int64, device=dev) * per)[:, None]
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    leaf_global = torch.where(idx < per, idx.long() + off, r)  # (L_src, S_dst, C)
    ix = torch.cat([hub.expand(l, s, h), leaf_global], dim=2).reshape(l, -1)
    send = _rows_at(slab, ix, r).view(l, s, h + cap, w)  # (L_src, S_dst, H+C, w)
    recv = all_to_all(send)  # (L_dst, S_src, H+C, w)
    idx_r = all_to_all(idx)  # (L_dst, S_src, C)
    view = torch.zeros((l, s, per + 1, w), dtype=x.dtype, device=dev)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    view.scatter_(2, idx_r.long().unsqueeze(-1).expand(l, s, cap, w), recv[:, :, h:])
    out = view[:, :, :per].transpose(1, 2).reshape(l, per, 128)
    if h:
        my_hub = (hub - off)[lo: lo + l]  # local rows, sentinel >= per
        hub_rows = recv[:, :, :h].transpose(1, 2).reshape(l, h, 128)
        out = torch.cat([out, torch.zeros((l, 1, 128), dtype=x.dtype, device=dev)], dim=1)
        out.scatter_(1, my_hub.clamp(max=per).unsqueeze(-1).expand(l, h, 128), hub_rows)
        out = out[:, :per]
    return out


def _sparse_pass(kind: str, blocks: torch.Tensor, *, table: torch.Tensor, cap: int, n_shards: int,
                 lo: int) -> torch.Tensor:
    if kind == "t":
        return transpose_pass_sparse(blocks, n_shards, table, cap, lo)
    return untranspose_pass_sparse(blocks, n_shards, table, cap, lo)


# ----------------------------------------------------------------- build


def build_transport(target, mode: str = "sparse", *, compact_frac: float = 0.125, hub_rows_frac: float = 1 / 32,
                    hub_degree_min: int | None = None, hosts: int = 1, mesh=None) -> Transport:
    """Compile the sparsity-adaptive transport for one engine's layout: a
    ``ShardedGraph`` gets the bucketed compact lane (budget ``compact_frac``
    of the bucket capacity), a ``MatchingPlan`` the hub/leaf transpose
    tables. ``mode`` "sparse" gates each exchange on its header alone;
    "auto" also requires the static geometry to predict a 25% byte win at
    full budget (else ``active=False`` and the rounds run dense). "hier"
    compiles the two-level transport of a (``hosts``, devices) mesh
    instead: a dense device stage and a compacted host stage
    (``cluster/hier.py``), whose budget ``dcn_budget`` is; it replaces the
    flat compact lane, so the hub/leaf tables stay empty. ``mesh`` puts the
    tables on its device; a matching transport is built from the plan this
    process holds (``shard_matching_plan(plan, mesh)``, or the distributed
    builder's), and keeps its leaf table's rows."""
    if mode not in ("sparse", "auto", "hier"):
        raise ValueError(f"transport mode {mode!r} must be sparse, auto, or hier")
    from tpu_gossip_torch.core.matching_topology import MatchingPlan

    if mode == "hier":
        return _build_hier_transport(target, compact_frac, hosts)
    if isinstance(target, MatchingPlan):
        return _build_matching_transport(target, mode, compact_frac, hub_rows_frac, hub_degree_min, mesh=mesh)
    return _build_bucketed_transport(target, mode, compact_frac)


def _build_hier_transport(target, compact_frac: float, hosts: int) -> Transport:
    from tpu_gossip_torch.core.matching_topology import MatchingPlan

    if hosts <= 1:
        raise ValueError("transport mode 'hier' needs a (hosts, devices) mesh — pass hosts > 1 (the flat mesh has "
                         "no DCN axis to compact)")
    if isinstance(target, MatchingPlan):
        s, per = target.mesh_shards, target.per_rows
        if s % hosts:
            raise ValueError(f"hier transport: hosts={hosts} does not divide the {s}-shard mesh")
        cap = min(max(1, per - 1), max(8, int(math.ceil(per * compact_frac))))
        return Transport(engine="matching", mode="hier", active=True, budget=cap, n_shards=s,
                         fingerprint=target.mesh_shards * target.per_rows, hosts=hosts, dcn_budget=cap)
    sg = target
    if sg.n_shards % hosts:
        raise ValueError(f"hier transport: hosts={hosts} does not divide the {sg.n_shards}-shard mesh")
    db = (sg.n_shards // hosts) * sg.bucket
    cap = max(8, min(db, int(math.ceil(db * compact_frac))))
    return Transport(engine="bucketed", mode="hier", active=True, budget=cap, n_shards=sg.n_shards,
                     fingerprint=sg.fingerprint, hosts=hosts, dcn_budget=cap)


def hier_take(x: torch.Tensor, transport: Transport) -> bool:
    """The hier pipeline's one gate a pass: the plane's nonzero words over
    the whole swarm (conserved by every stage, so they bound each host
    stage's occupied rows) within the host stage's budget."""
    from tpu_gossip_torch.cluster.topology import reduce_sum

    return bool(reduce_sum((x != 0).sum()) <= transport.dcn_budget)


def _build_bucketed_transport(sg, mode: str, compact_frac: float) -> Transport:
    b = sg.bucket
    cap = max(8, min(b, int(math.ceil(b * compact_frac))))
    # the compact lane at full budget ships about cap*3 words a pair against
    # B dense at one payload byte: require a 25% predicted win
    active = not (mode == "auto" and cap * 3 > 0.75 * b)
    return Transport(engine="bucketed", mode=mode, active=active, budget=cap, n_shards=sg.n_shards,
                     fingerprint=sg.fingerprint)


def _hub_slots(classes: tuple, r: int, hub_rows_frac: float, hub_degree_min: int | None) -> tuple[list, int]:
    """The stage-0 hub classes of the global class table ``classes`` over
    ``r`` slot rows, as (slot_off, span) runs: the highest-degree classes
    within the row budget, or every class at or above ``hub_degree_min``;
    and the degree floor chosen. Host arithmetic over the table only."""
    runs = []
    if hub_degree_min is None:
        row_budget = int(r * hub_rows_frac)
        used, chosen_min = 0, None
        for _node_off, slot_off, _count, pad_deg, cstride in sorted(classes, key=lambda c: -c[3]):
            span = pad_deg * cstride
            rows_used = -(-span // 128) + 1
            if used + rows_used > row_budget:
                break
            used += rows_used
            runs.append((slot_off, span))
            chosen_min = pad_deg if chosen_min is None else min(chosen_min, pad_deg)
        return runs, 0 if chosen_min is None else chosen_min
    for _node_off, slot_off, _count, pad_deg, cstride in classes:
        if pad_deg >= hub_degree_min:
            runs.append((slot_off, pad_deg * cstride))
    return runs, hub_degree_min


def _build_matching_transport(plan, mode, compact_frac, hub_rows_frac, hub_degree_min, *, mesh=None) -> Transport:
    """The hub/leaf tables from the plan this process holds (every shard in
    one process, its host row's shards, from ``plan.shard_lo`` on, in a
    rank): the hub classes chosen from the global class layout, the held
    hub-ness pushed through the held pipeline (its transposes crossing the
    process group), every stage's row mask joined over the processes in
    one all-gather, and the (S, H_k) tables built from them alike on
    every process."""
    from tpu_gossip_torch.cluster.topology import gather_joined, world
    from tpu_gossip_torch.dist.builder import held_classes
    from tpu_gossip_torch.kernels.permute import lane_shuffle, transpose_pass_sharded, untranspose_pass_sharded

    s, per = plan.mesh_shards, plan.per_rows
    r, lo, held = s * per, plan.shard_lo, plan.rows // per
    if held * world() != s or (mesh is not None and (mesh.lo, mesh.local) != (lo, held)):
        raise ValueError(f"the plan holds shards [{lo}, {lo + held}) of {s} but this process holds "
                         f"{s // world()} — build the transport from the plan placed on the mesh "
                         "(shard_matching_plan(plan, mesh))")
    cap = min(max(1, per - 1), max(8, int(math.ceil(per * compact_frac))))
    runs, hub_degree_min = _hub_slots(held_classes(plan.local_classes, s, plan.n_blk, per), r, hub_rows_frac,
                                      hub_degree_min)
    # the held rows of the stage-0 hub slots (a class lies in one shard block)
    base = lo * per * 128
    hub_flat = np.zeros(held * per * 128, dtype=bool)
    for slot_off, span in runs:
        if base <= slot_off < base + hub_flat.size:
            hub_flat[slot_off - base: slot_off - base + span] = True
    hub0 = hub_flat.reshape(held * per, 128)
    dev = plan.valid.device

    # hub-ness pushed through the held pipeline once: the row-any mask
    # before each "t" and after each "tinv"
    ind = torch.from_numpy(hub0.astype(np.int32)).to(dev)
    masks = []
    for stage in plan.stages:
        if stage[0] == "lane":
            ind = lane_shuffle(ind, stage[1])
        elif stage[0] == "t":
            masks.append((ind != 0).any(1))
            ind = transpose_pass_sharded(ind.view(held, per, 128), s).view(held * per, 128)
        else:
            ind = untranspose_pass_sharded(ind.view(held, per, 128), s).view(held * per, 128)
            masks.append((ind != 0).any(1))
    joined = gather_joined(torch.stack(masks, dim=1).to(torch.uint8), label="build transport").cpu().numpy()
    masks = [joined[:, i] != 0 for i in range(len(masks))]

    tables, stage_mode = [], []
    for mask in masks:
        per_shard = mask.reshape(s, per)
        h = int(per_shard.sum(axis=1).max())
        if h + cap < max(per // 2, 1):
            smode = "hub"
        elif cap < per:
            smode, h = "plain", 0
        else:
            smode, h = "dense", 0
        tbl = np.full((s, h), per, dtype=np.int32)
        for sh in range(s if h else 0):
            rows = np.flatnonzero(per_shard[sh]).astype(np.int32)
            tbl[sh, : len(rows)] = rows
        tables.append(tbl)
        stage_mode.append(smode)
    ti = 0
    for stage in plan.stages:  # "tinv" tables hold global rows
        if stage[0] == "t":
            ti += 1
        elif stage[0] == "tinv":
            tbl = tables[ti]
            glob = tbl + (np.arange(s, dtype=np.int32) * per)[:, None]
            tables[ti] = np.where(tbl < per, glob, r).astype(np.int32)
            ti += 1

    active = True
    if mode == "auto":
        shipped = sum(per * 128 if sm == "dense" else (t.shape[1] + cap) * 128 + cap
                      for t, sm in zip(tables, stage_mode))
        if shipped * 4 > 3 * len(tables) * per * 128:
            active = False
    put = dev if mesh is None else mesh.device
    return Transport(
        leaf_slots=torch.from_numpy(~hub0).to(put), hub_tables=tuple(torch.from_numpy(t).to(put) for t in tables),
        engine="matching", mode=mode, active=active, budget=cap, stage_mode=tuple(stage_mode),
        hub_degree_min=int(hub_degree_min), n_shards=s, fingerprint=r, shard_lo=lo,
    )


# ------------------------------------------------------- analytic counter


def bucketed_dense_exchange_words(s: int, b: int, nbytes: int) -> int:
    """Global dense 4-byte words of ONE bucketed exchange: each of ``s``
    shards ships its (S, B, nbytes) uint8 payload, rounded up to whole
    words a shard."""
    return s * (-(-(s * b * nbytes) // 4))


def matching_dense_stage_words(rows: int) -> int:
    """Global dense 4-byte words of ONE matching transpose stage: one (R,
    128) byte plane."""
    return rows * 32


def ici_round_bucketed(sg, transport: Transport | None, nbytes: int, tx_any: torch.Tensor,
                       ans_any: torch.Tensor | None, merged: bool, hosts: int = 1) -> IciRound:
    """Analytic ICI words of one bucketed round (fault-free model):
    ``tx_any``/``ans_any`` are the per-row nonzero-word indicators of the
    planes the round exchanges, stale-masked as the exchange masks them;
    the merged push_pull wire carries one billing byte more. On a mesh of
    ``hosts`` > 1 rows a flat exchange is priced whole on the host axis
    (``dcn_*`` = the wire); a hier transport bills its dense device stage
    and its host stage, gated on the host stage's occupancy, as the JAX
    package does. The counts are the whole swarm's on every process."""
    from tpu_gossip_torch.cluster.topology import reduce_max, reduce_sum

    s, b, per = sg.n_shards, sg.bucket, sg.per_shard
    dev = tx_any.device
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    srcg = (sg.send_src.long() + (torch.arange(sg.stacked, dtype=torch.int64, device=dev) * per)[:, None, None]).to(dev)
    z = _i(0, dev)
    hier = transport is not None and transport.hier

    def one(plane_any, nb):
        occ = sg.send_valid.to(dev) & plane_any[srcg]
        counts = occ.sum(-1)  # (S held, S)
        dense = _i(bucketed_dense_exchange_words(s, b, nb), dev)
        occupied = (reduce_sum(counts.sum()).to(dev) * nb + 3) // 4
        if hier:
            h, cap = transport.hosts, transport.dcn_budget
            d = s // h
            # post-device-stage occupancy: a host's entries for one
            # destination shard, summed over its devices and the bucket
            hcounts = occ.view(-1, d, h, d, b).sum((1, 4))
            fit = reduce_max(hcounts.max()).to(dev) <= cap
            header = _i(s * h, dev)
            compact = _i(s * h * cap + s * (-(-(h * cap * nb) // 4)), dev)
            dcn_shipped = torch.where(fit, compact + header, dense + header)
            return IciRound(dense + dense, dense + dcn_shipped, occupied, fit.long(), _i(1, dev), dense, dcn_shipped)
        if transport is None or not transport.active:
            dd = dense if hosts > 1 else z
            return IciRound(dense, dense, occupied, z, z, dd, dd)
        cap = transport.budget
        fit = reduce_max(counts.max()).to(dev) <= cap
        compact = _i(s * s * cap + s * (-(-(s * cap * nb) // 4)), dev)
        shipped = torch.where(fit, compact, dense) + s * s
        return IciRound(dense, shipped, occupied, fit.long(), _i(1, dev), dense if hosts > 1 else z,
                        shipped if hosts > 1 else z)

    out = one(tx_any, nbytes + 1 if merged else nbytes)
    if ans_any is not None:
        out = _add_ici(out, one(ans_any, nbytes))
    return out


def ici_round_matching(plan, transport: Transport | None, m: int, tx: torch.Tensor,
                       answer: torch.Tensor | None, hosts: int = 1) -> IciRound:
    """Analytic ICI words of one matching round's transpose passes: per
    8-slot byte group one (R, 128) byte plane through every transpose stage
    (the pull direction reuses the push plane unless ``answer`` ships its
    own). Occupied words are the plane's nonzero slots in bytes; the
    shipped figure takes the static lane shapes and the leaf index plane
    where the conserved count fits the budget, plus the 2S-word header.
    This is the JAX package's wire, gated per byte group; the port's
    pipeline gates each 32-slot int32 plane (:meth:`Transport.gates`,
    counted by :func:`lane_counts`). On a mesh of ``hosts`` > 1 rows a flat
    pipeline is priced whole on the host axis; a hier transport bills its
    dense device stages and its host stages (the compacted (cap, 128)
    payload and an (H, cap) index plane a shard, gated on the one
    conserved count, an S-word header), as the JAX package does. The
    counts are the whole swarm's on every process."""
    from tpu_gossip_torch.cluster.topology import reduce_sum

    s = plan.mesh_shards
    r = s * plan.per_rows
    dev = tx.device
    hier = transport is not None and transport.hier
    active = transport is not None and transport.active and not hier
    if active:
        n_stages = len(transport.hub_tables)
        leaf = transport.leaf_slots.to(dev).long()
    else:
        n_stages = sum(1 for st in plan.stages if st[0] in ("t", "tinv"))
    dense_stage = matching_dense_stage_words(r)
    z = _i(0, dev)

    def one(plane):
        total = zero_ici(dev)
        for lo in range(0, m, 8):
            nzn = plane[: plan.n, lo: lo + 8].any(1).to(torch.int32)
            # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
            slots = plan.expand(nzn).long()
            counts = torch.stack([slots.sum(), (slots * leaf).sum() if active else slots.sum()])
            nz, nz_leaf = reduce_sum(counts).to(dev)
            dense = _i(dense_stage * n_stages, dev)
            occupied = (nz * n_stages + 3) // 4
            if hier:
                h, hcap = transport.hosts, transport.dcn_budget
                take = nz <= hcap
                compact = _i(s * hcap * 32 + s * h * hcap, dev)
                dcn_shipped = n_stages * torch.where(take, compact, _i(dense_stage, dev)) + s
                total = _add_ici(total, IciRound(dense + dense, dense + dcn_shipped, occupied,
                                                 take.long() * n_stages, _i(n_stages, dev), dense, dcn_shipped))
                continue
            if not active:
                dd = dense if hosts > 1 else z
                total = _add_ici(total, IciRound(dense, dense, occupied, z, z, dd, dd))
                continue
            cap = transport.budget
            take_leaf = nz_leaf <= cap
            take_total = nz <= cap
            shipped, taken, lanes = _i(2 * s, dev), z, 0
            for tbl, sm in zip(transport.hub_tables, transport.stage_mode):
                if sm == "dense":
                    shipped = shipped + dense_stage
                    continue
                take = take_leaf if sm == "hub" else take_total
                compact = s * (tbl.shape[1] + cap) * 32 + s * s * cap
                shipped = shipped + torch.where(take, _i(compact, dev), _i(dense_stage, dev))
                taken = taken + take.long()
                lanes += 1
            total = _add_ici(total, IciRound(dense, shipped, occupied, taken, _i(lanes, dev),
                                             dense if hosts > 1 else z, shipped if hosts > 1 else z))
        return total

    out = one(tx)
    if answer is not None:
        out = _add_ici(out, one(answer))
    return out
