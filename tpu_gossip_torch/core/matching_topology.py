"""Structured-matching power-law topology: the gather-free graph family.

Ports ``tpu_gossip/core/matching_topology.py``: ``quantile_degrees``
(:424), ``_plan_classes`` (:434), ``MatchingPlan`` (:218),
``pipeline_stages``, ``expand_classes``, ``reduce_classes``,
``deg_table_dtype``, ``sharded_layout`` (:101), ``_build_plan`` (:488, the
``block_keys=False`` derivation, with and without the CSR export, with
JAX's ``sentinel`` and ``int8_tables`` overrides),
``matching_powerlaw_graph`` (:683) and ``matching_powerlaw_graph_sharded``
(:741, its ``block_keys=False`` derivation at any shard count dividing
128, with ``growth_rows``: the local engine runs it through the plan's
global classes view, and it is the matching layout of a growing run).
With ``block_keys=True`` the random tables draw per shard block and the
erased edges absorb into each shard's own pad row (the distributable
derivation ``dist/builder.py`` reproduces one shard at a time);
``plan_table_widths`` (:146) is the plan's table ledger.

Degrees are the truncated-Pareto law at deterministic quantiles; nodes are
grouped into classes of equal padded degree; slot ``j``'s partner is
``pi(j)`` for the involution ``pi = sigma . M3 . sigma^-1`` built from random
per-row lane permutations and transposes (kernels/permute.py). Every
partner quantity of the build is computed by pushing plan vectors through
the pipeline itself, so the build runs the same lane-shuffle kernel (K1)
as the rounds, and the realized degrees fold through K2.

Expand and reduce follow the JAX layout exactly (position-major classes
of count >= 8192 with 1024-aligned planes, node-major classes otherwise).
Expand is one gather through a slot -> node table computed once per plan
(:class:`ClassLayout`); reduce is one K2 launch (``fold_classes``) over
the plan's class table, node gaps and the tail included.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import DeviceGraph
from tpu_gossip_torch.core.topology import pareto_icdf
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.permute import apply_pipeline, fold_classes, fold_work, inverse_tables
from tpu_gossip_torch.kernels.pallas_segment import bernoulli_threshold_device

__all__ = [
    "DEG_TABLE_CAP",
    "ClassLayout",
    "MatchingPlan",
    "MeshRoute",
    "class_layout",
    "class_table",
    "deg_table_dtype",
    "expand_classes",
    "matching_powerlaw_graph",
    "matching_powerlaw_graph_sharded",
    "plan_table_widths",
    "pipeline_stages",
    "quantile_degrees",
    "reduce_classes",
    "sharded_layout",
]

DEG_TABLE_CAP = 2**15 - 1

def deg_table_dtype(d_max: int) -> torch.dtype:
    """The declared degree-table dtype for a build capped at ``d_max``."""
    return torch.int16 if d_max <= DEG_TABLE_CAP else torch.int32


def sharded_layout(n: int, n_shards: int, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None,
                   growth_rows: int = 0) -> dict:
    """The host planning of the sharded matching layout (JAX's law): each
    of ``n_shards`` identical blocks holds ``n_per = ceil(n / n_shards)``
    peers at the quantile degrees of ``n_per``, ``growth_rows`` reserved
    rows and one pad row; each shard's slot rows round up to whole
    (gran, 128) tiles, gran 32 when the global slot count reaches 2^19."""
    if d_max is None:
        d_max = max(d_min + 1, int(round(n ** (1.0 / (gamma - 1.0)))))
    n_per = -(-n // n_shards)
    deg_local = quantile_degrees(n_per, gamma, d_min, d_max)
    local_classes = _plan_classes(deg_local)
    last = local_classes[-1]
    n_slots_local = last[1] + last[3] * last[4]
    gran = 32 if n_slots_local * n_shards >= (1 << 19) else 8
    per_rows = math.ceil(n_slots_local / (128 * gran)) * gran
    rows = per_rows * n_shards
    n_blk = n_per + growth_rows + 1
    return {
        "d_max": d_max,
        "n_per": n_per,
        "deg_local": deg_local,
        "local_classes": local_classes,
        "per_rows": per_rows,
        "rows": rows,
        "n_blk": n_blk,
        "n_state": n_shards * n_blk,
        "n_stages": max(2, math.ceil(math.log(max(rows, 2)) / math.log(128))),
        "int8_tables": per_rows % 32 == 0,
    }


def plan_table_widths(n: int, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None,
                      n_shards: int = 1) -> dict:
    """The declared MatchingPlan table widths and bytes at a scale (JAX's
    ``plan_table_widths``): host arithmetic only, ``name -> {dtype, shape,
    bytes, why}``."""
    if n_shards > 1:
        lay = sharded_layout(n, n_shards, gamma, d_min, d_max)
        d_max, rows = lay["d_max"], lay["rows"]
        int8_ok, n_state, k = lay["int8_tables"], lay["n_state"], lay["n_stages"]
    else:
        d_max, _, _, rows = plan_shape(n, gamma, d_min, d_max)
        int8_ok, n_state = rows % 32 == 0, n + 1
        k = max(2, math.ceil(math.log(max(rows, 2)) / math.log(128)))
    lane_dt, lane_b = ("int8", 1) if int8_ok else ("int32", 4)
    deg_dt, deg_b = ("int16", 2) if d_max <= DEG_TABLE_CAP else ("int32", 4)
    slots = rows * 128
    return {
        "lanes": {"dtype": lane_dt, "shape": f"({k}, {rows}, 128)", "bytes": k * slots * lane_b,
                  "why": "lane ids < 128 — int8 when the (32, 128) tile granularity holds"},
        "lanes_inv": {"dtype": lane_dt, "shape": f"({k}, {rows}, 128)", "bytes": k * slots * lane_b,
                      "why": "inverse tables, same law"},
        "m3": {"dtype": lane_dt, "shape": f"({rows}, 128)", "bytes": slots * lane_b,
               "why": "pairing involution, lane ids"},
        "valid": {"dtype": "bool", "shape": f"({rows}, 128)", "bytes": slots, "why": "erasure-survivor bit"},
        "deg_other": {"dtype": deg_dt, "shape": f"({rows}, 128)", "bytes": slots * deg_b,
                      "why": f"partner degrees <= d_max={d_max}; int16 saturating at DEG_TABLE_CAP={DEG_TABLE_CAP} "
                      "when the cap permits"},
        "deg_real": {"dtype": deg_dt, "shape": f"({n_state},)", "bytes": n_state * deg_b,
                     "why": "realized degrees, same cap"},
    }


# classes at or above this node count store slots position-major with
# 1024-aligned plane strides (folded by K2); smaller classes node-major
_POS_MAJOR_MIN = 8192


@dataclasses.dataclass(frozen=True)
class ClassLayout:
    """Index tables of a class layout (plan-time, derived from ``classes``).

    ``slot_node`` (rows*128,) int32 is the node each slot broadcasts from,
    ``n`` for dead slots (alignment gaps, stride padding, the tail), which
    read as 0. ``table_rows`` is the class table (:func:`class_table`),
    ``table`` the same (rows, 6) int64 on the plan's device and ``work``
    K2's (blocks, 4) int32 work table over it (``permute.fold_work``).
    """

    n: int
    slot_node: torch.Tensor
    table_rows: tuple
    table: torch.Tensor
    work: torch.Tensor


def class_table(classes: tuple, n_out: int) -> tuple:
    """K2's class table of ``classes`` over ``n_out`` nodes: one row
    (node_off, slot_off, count, pad_deg, plane_stride, node_stride) a class,
    position-major (count >= 8192) with (cstride, 1) strides and node-major
    with (1, pad_deg), and a pad_deg-0 row, which folds to zeros, for each
    node gap and for the tail up to ``n_out`` (JAX ``reduce_classes``)."""
    rows, cur = [], 0
    for node_off, slot_off, count, pad_deg, cstride in classes:
        if node_off > cur:
            rows.append((cur, 0, node_off - cur, 0, 0, 0))
        strides = (cstride, 1) if count >= _POS_MAJOR_MIN else (1, pad_deg)
        rows.append((node_off, slot_off, count, pad_deg) + strides)
        cur = node_off + count
    if n_out > cur:
        rows.append((cur, 0, n_out - cur, 0, 0, 0))
    return tuple(rows)


def class_layout(classes: tuple, rows: int, n: int, device) -> ClassLayout:
    """The :class:`ClassLayout` of ``classes`` over ``rows`` slot rows."""
    slot_node = np.full(rows * 128, n, dtype=np.int32)
    for node_off, slot_off, count, pad_deg, cstride in classes:
        ids = np.arange(node_off, node_off + count, dtype=np.int32)
        if count >= _POS_MAJOR_MIN:
            plane = np.full(cstride, n, dtype=np.int32)
            plane[:count] = ids
            slot_node[slot_off : slot_off + pad_deg * cstride] = np.tile(plane, pad_deg)
        else:
            slot_node[slot_off : slot_off + count * pad_deg] = np.repeat(ids, pad_deg)
    table = class_table(classes, n)
    return ClassLayout(
        n=n,
        slot_node=torch.from_numpy(slot_node).to(device),
        table_rows=table,
        table=torch.tensor(table, dtype=torch.int64).reshape(-1, 6).to(device),
        work=torch.from_numpy(fold_work(table)).to(device),
    )


@dataclasses.dataclass(frozen=True)
class MeshRoute:
    """How a plan on the one-process mesh moves its slot data: the sharded
    passes, each transpose on its compact lane where ``transport`` (an
    active ``dist.transport.Transport``, or None: always dense) admits it."""

    transport: object = None


@dataclasses.dataclass(frozen=True)
class MatchingPlan:
    """Static routing state for structured-matching delivery (the JAX
    field order). ``classes`` holds (node_off, slot_off, count, pad_deg,
    cstride) runs; lane tables are int8 (int32 on small plans); ``valid``
    marks slots that survived erasure; sampling gates are computed per
    round from ``deg_other``/``deg_real``. ``layout`` is the port's index
    view of ``classes``; ``route``, set on a plan a mesh round runs, makes
    :meth:`partner` take the sharded passes. A process of a multi-process
    mesh holds its shards' rows of every table, from shard ``shard_lo`` on,
    with ``n``, ``rows``, ``classes`` and ``layout`` its own."""

    lanes: tuple
    m3: torch.Tensor
    lanes_inv: tuple
    valid: torch.Tensor
    deg_other: torch.Tensor | None
    deg_real: torch.Tensor | None = None
    n: int = 0
    rows: int = 0
    classes: tuple = ()
    fanout: int | None = None
    mesh_shards: int = 1
    n_per: int = 0
    n_blk: int = 0
    per_rows: int = 0
    local_classes: tuple = ()
    layout: ClassLayout | None = dataclasses.field(default=None, compare=False, repr=False)
    route: MeshRoute | None = dataclasses.field(default=None, compare=False, repr=False)
    shard_lo: int = 0

    @property
    def draw_offset(self) -> int:
        """Where this plan's slots sit in the global (S·per_rows, 128) draw:
        0 unless a process holds the shards from ``shard_lo`` on
        (``dist/matching_mesh.py::shard_matching_plan``)."""
        return self.shard_lo * self.per_rows * 128

    def with_fanout(self, fanout: int) -> "MatchingPlan":
        """Rebind the sampling fanout (gates are computed per round)."""
        if self.deg_other is None:
            raise ValueError("plan carries no partner degrees")
        return dataclasses.replace(self, fanout=fanout)

    def push_threshold(self, fanout: int | None = None) -> torch.Tensor:
        """Per-slot uint32 push gate (int64): B(fanout/deg(sender)), 0 off-edge."""
        f = self.fanout if fanout is None else fanout
        # graftlint: disable=mem-widening-cast -- the gate probability is a float32 ratio, as JAX computes it
        p = f / torch.clamp(self.deg_other, min=1).to(torch.float32)
        return torch.where(
            self.valid & (self.deg_other > 0), bernoulli_threshold_device(p), 0
        )

    def pull_threshold(self) -> torch.Tensor:
        """Per-slot uint32 pull gate (int64): B(1/deg(puller)), 0 off-edge."""
        deg_self = self.expand(self.deg_real)
        # graftlint: disable=mem-widening-cast -- the gate probability is a float32 ratio, as JAX computes it
        p = 1.0 / torch.clamp(deg_self, min=1).to(torch.float32)
        return torch.where(self.valid & (deg_self > 0), bernoulli_threshold_device(p), 0)

    @property
    def stages(self) -> tuple:
        """The pairing involution as a permute.apply_pipeline stage tuple."""
        return pipeline_stages(self.lanes, self.m3, self.lanes_inv)

    def partner(self, x: torch.Tensor) -> torch.Tensor:
        """out[j] = x[pi(j)] over (R, 128) int32 slot data: one pipeline pass,
        the fused local one, or on a mesh (``route``) the sharded one over
        the ``mesh_shards`` stacked blocks with the transport's gated lanes."""
        if self.route is None:
            return apply_pipeline(x, self.stages)
        tr = self.route.transport
        if tr is not None and tr.hier:
            from tpu_gossip_torch.cluster.hier import apply_pipeline_hier
            from tpu_gossip_torch.dist.transport import hier_take

            return apply_pipeline_hier(x, self.stages, tr.hosts, self.mesh_shards, self.per_rows, tr.dcn_budget,
                                       hier_take(x, tr))
        lanes = None if tr is None else tr.lanes(*tr.gates(x))
        return apply_pipeline(x, self.stages, n_shards=self.mesh_shards, lanes=lanes, per=self.per_rows)

    def expand(self, x_n: torch.Tensor) -> torch.Tensor:
        """Broadcast per-node values (n,) onto slots (R, 128)."""
        return expand_classes(x_n, self.layout, self.rows)

    def reduce(self, slots: torch.Tensor, op: str = "or") -> torch.Tensor:
        """Fold slot values (R, 128) into per-node values (n,)."""
        return reduce_classes(slots, self.layout, op)


def pipeline_stages(lanes: tuple, m3, lanes_inv: tuple) -> tuple:
    """sigma . M3 . sigma^-1 as a stage tuple for permute.apply_pipeline."""
    fwd = []
    for ln in lanes:
        fwd += [("lane", ln), ("t",)]
    bwd = []
    for ln in reversed(lanes_inv):
        bwd += [("tinv",), ("lane", ln)]
    return tuple(fwd) + (("lane", m3),) + tuple(bwd)


def expand_classes(x_n: torch.Tensor, layout: ClassLayout, rows: int) -> torch.Tensor:
    """Broadcast per-node values onto slots (rows, 128); dead slots read 0."""
    if x_n.shape[0] != layout.n:
        raise ValueError(f"expand takes ({layout.n},) node values, got {tuple(x_n.shape)}")
    ext = torch.cat([x_n, x_n.new_zeros(1)])
    return ext.index_select(0, layout.slot_node).view(rows, 128)


def reduce_classes(slots: torch.Tensor, layout: ClassLayout, op: str = "or") -> torch.Tensor:
    """Fold slot values (rows, 128) into per-node values (layout.n,), ``op``
    "or" (delivery words) or "sum" (degree counts): one K2 launch over the
    layout's class table on the card (``permute.fold_classes``)."""
    return fold_classes(slots, layout, op)


def quantile_degrees(n: int, gamma: float, d_min: int, d_max: int) -> np.ndarray:
    """Ascending deterministic degree sequence: the truncated-Pareto inverse
    CDF at quantiles (i+0.5)/n."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    x = pareto_icdf(u, gamma, d_min, d_max)
    return np.minimum(np.floor(x), d_max).astype(np.int32)


def _plan_classes(deg: np.ndarray, pad_ratio: float = 1.06) -> tuple:
    """Greedy runs over the ascending degrees with pad_deg = run max and
    max/min <= pad_ratio: (node_off, slot_off, count, pad_deg, cstride)
    tuples; populous classes get 1024-aligned strides and offsets."""
    n = len(deg)
    classes = []
    i = 0
    slot_off = 0
    deg = np.asarray(deg)
    ndt = deg.dtype.type
    while i < n:
        d0 = max(1, int(deg[i]))
        limit = max(d0, int(d0 * pad_ratio))
        j = int(np.searchsorted(deg, ndt(limit), side="right"))
        j = max(j, i + 1)
        pad_deg = max(1, int(deg[j - 1]))
        count = j - i
        if count >= _POS_MAJOR_MIN:
            cstride = -(-count // 1024) * 1024
            slot_off = -(-slot_off // 1024) * 1024
        else:
            cstride = count
        classes.append((i, slot_off, count, pad_deg, cstride))
        slot_off += pad_deg * cstride
        i = j
    return tuple(classes)


def _real_mask(deg: torch.Tensor, classes: tuple, rows: int) -> torch.Tensor:
    """Slots that hold one of their node's real stubs (pos < deg)."""
    real = torch.zeros((rows * 128,), dtype=torch.bool, device=deg.device)
    for node_off, slot_off, count, pad_deg, cstride in classes:
        d = deg[node_off : node_off + count]
        pos = torch.arange(pad_deg, dtype=torch.int32, device=deg.device)
        if count >= _POS_MAJOR_MIN:
            if cstride != count:
                d = torch.cat([d, d.new_zeros(cstride - count)])
            mask = (pos[:, None] < d[None, :]).reshape(-1)
        else:
            mask = (pos[None, :] < d[:, None]).reshape(-1)
        real[slot_off : slot_off + mask.numel()] = mask
    return real.view(rows, 128)


def _build_plan(key: torch.Tensor, deg: torch.Tensor, *, n: int, rows: int,
                classes: tuple, layout: ClassLayout, export_csr: bool = True,
                sentinel: int | None = None, int8_tables: bool | None = None,
                deg_cap: int | None = None, block_keys: bool = False, n_shards: int = 1,
                n_blk: int = 0):
    """The plan derivation of JAX ``_build_plan``. ``sentinel`` None
    appends row ``n`` to the CSR to absorb the erased edges; the sharded
    layout passes its last pad row instead, so the CSR has exactly ``n``
    rows. ``int8_tables`` overrides the narrow lane-table choice (default:
    ``rows % 32 == 0``). ``block_keys`` (with ``n_shards``/``n_blk``)
    draws every table as per-shard ``fold_in(stage_key, shard)`` blocks
    and absorbs each shard's erased edges into its own pad row."""
    r = rows
    dev = deg.device
    n_stages = max(2, math.ceil(math.log(max(r, 2)) / math.log(128)))
    keys = prng.split(key, n_stages + 1)
    if int8_tables is None:
        int8_tables = r % 32 == 0
    tdt = torch.int8 if int8_tables else torch.int32

    def table_bits(k):
        if not block_keys:
            return prng.uniform(k, (r, 128))
        per = r // n_shards
        return torch.cat([prng.uniform(prng.fold_in(k, sh), (per, 128)) for sh in range(n_shards)])

    lanes = tuple(
        torch.argsort(table_bits(keys[i]), dim=1, stable=True).to(tdt)
        for i in range(n_stages)
    )
    p = torch.argsort(table_bits(keys[n_stages]), dim=1, stable=True)
    a, b = p[:, 0::2], p[:, 1::2]
    m3 = torch.zeros((r, 128), dtype=torch.int64, device=dev)
    m3.scatter_(1, a, b)
    m3.scatter_(1, b, a)
    m3 = m3.to(tdt)
    lanes_inv = tuple(inverse_tables(ln) for ln in lanes)
    plan0 = MatchingPlan(
        lanes=lanes, m3=m3, lanes_inv=lanes_inv,
        valid=torch.zeros((r, 128), dtype=torch.bool, device=dev), deg_other=None,
        n=n, rows=r, classes=classes, layout=layout,
    )

    owner = plan0.expand(torch.arange(n, dtype=torch.int32, device=dev))
    sentinel_fill = torch.arange(r * 128, dtype=torch.int32, device=dev).view(r, 128)
    layout_end = classes[-1][1] + classes[-1][3] * classes[-1][4]
    owner = torch.where(sentinel_fill < layout_end, owner, n)
    real = _real_mask(deg, classes, r)

    part = plan0.partner(sentinel_fill)
    other_owner = plan0.partner(owner)
    partner_real = plan0.partner(real.to(torch.int32)) > 0
    alive = real & partner_real & (other_owner != owner) & (other_owner < n)

    # duplicate-edge erasure: lexsort by (ulo, uhi) as two stable sorts
    canonical = alive & (sentinel_fill < part)
    ulo = torch.where(canonical, torch.minimum(owner, other_owner), n).reshape(-1)
    uhi = torch.where(canonical, torch.maximum(owner, other_owner), n).reshape(-1)
    o1 = torch.argsort(uhi, stable=True)
    order = o1[torch.argsort(ulo[o1], stable=True)]
    slo, shi = ulo[order], uhi[order]
    dup_sorted = torch.zeros_like(slo, dtype=torch.bool)
    dup_sorted[1:] = (slo[1:] == slo[:-1]) & (shi[1:] == shi[:-1]) & (slo[1:] != n)
    dup = torch.zeros((r * 128,), dtype=torch.bool, device=dev)
    dup[order] = dup_sorted
    dup = dup.view(r, 128)
    dup_both = dup | (plan0.partner(dup.to(torch.int32)) > 0)
    valid = alive & ~dup_both

    deg_i32 = plan0.reduce(valid.to(torch.int32), op="sum")
    narrow = deg_cap is not None and deg_cap <= DEG_TABLE_CAP
    deg_real = torch.clamp(deg_i32, max=DEG_TABLE_CAP).to(torch.int16) if narrow else deg_i32
    deg_other = plan0.partner(plan0.expand(deg_i32))
    if narrow:
        deg_other = torch.clamp(deg_other, max=DEG_TABLE_CAP).to(torch.int16)

    sent_row = n if sentinel is None else sentinel
    n_rows = n + 1 if sentinel is None else n  # CSR rows, the sentinel's included
    if block_keys:  # each shard's erased edges absorb into its own pad row
        shard_of = sentinel_fill.reshape(-1) // ((r // n_shards) * 128)
        sent_row = shard_of * n_blk + (n_blk - 1)
    if export_csr:
        src = torch.where(valid.reshape(-1), owner.reshape(-1), sent_row)
        dst = torch.where(valid.reshape(-1), other_owner.reshape(-1), sent_row)
        csr_order = torch.argsort(src, stable=True)
        col_idx = dst[csr_order]
        row_ptr = torch.searchsorted(
            src[csr_order], torch.arange(n_rows + 1, dtype=torch.int32, device=dev), side="left"
        ).to(torch.int32)
    else:
        row_ptr = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(deg_real, 0, dtype=torch.int32),
        ])
        if sentinel is None:  # deg_real covers n rows; add the sentinel's
            row_ptr = torch.cat([row_ptr, row_ptr[-1:]])
        col_idx = torch.zeros((1,), dtype=torch.int32, device=dev)
    return lanes, m3, lanes_inv, valid, deg_other, deg_real, row_ptr, col_idx


def plan_shape(n: int, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None):
    """Host planning of the classic layout: (d_max, degrees, classes, rows)."""
    if d_max is None:
        d_max = max(d_min + 1, int(round(n ** (1.0 / (gamma - 1.0)))))
    deg_host = quantile_degrees(n, gamma, d_min, d_max)
    classes = _plan_classes(deg_host)
    last = classes[-1]
    n_slots = last[1] + last[3] * last[4]
    gran = 32 if n_slots >= (1 << 19) else 8
    rows = math.ceil(n_slots / (128 * gran)) * gran
    return d_max, deg_host, classes, rows


def matching_powerlaw_graph(
    n: int,
    gamma: float = 2.5,
    d_min: int = 2,
    d_max: int | None = None,
    *,
    fanout: int | None = None,
    key: torch.Tensor | None = None,
    export_csr: bool = True,
    device: str | torch.device = "cuda",
) -> tuple[DeviceGraph, MatchingPlan]:
    """Build the structured-matching power-law swarm on ``device``.

    Returns ``(graph, plan)``: a sentinel-row DeviceGraph to feed
    ``init_swarm`` and the MatchingPlan whose pipeline delivers rounds.
    ``export_csr=False`` skips the CSR sorts for runs that never read it.
    """
    dev = resolve_device(device)
    if key is None:
        key = prng.key(0, dev)
    d_max, deg_host, classes, rows = plan_shape(n, gamma, d_min, d_max)
    layout = class_layout(classes, rows, n, dev)
    deg = torch.from_numpy(deg_host).to(dev)
    lanes, m3, lanes_inv, valid, deg_other, deg_real, row_ptr, col_idx = _build_plan(
        key.to(dev), deg, n=n, rows=rows, classes=classes, layout=layout,
        export_csr=export_csr, deg_cap=d_max,
    )
    plan = MatchingPlan(
        lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid,
        deg_other=deg_other, deg_real=deg_real, n=n, rows=rows, classes=classes,
        fanout=fanout, mesh_shards=1, n_per=n, n_blk=n + 1, per_rows=rows,
        local_classes=classes, layout=layout,
    )
    exists = torch.arange(n + 1, device=dev) < n
    return DeviceGraph(row_ptr=row_ptr, col_idx=col_idx, exists=exists, n=n), plan


def matching_powerlaw_graph_sharded(
    n: int,
    n_shards: int,
    gamma: float = 2.5,
    d_min: int = 2,
    d_max: int | None = None,
    *,
    fanout: int | None = None,
    key: torch.Tensor | None = None,
    export_csr: bool = True,
    growth_rows: int = 0,
    block_keys: bool = False,
    device: str | torch.device = "cuda",
) -> tuple[DeviceGraph, MatchingPlan]:
    """The structured-matching swarm laid out for an ``n_shards`` mesh (JAX
    ``matching_powerlaw_graph_sharded``).

    The slot array is ``n_shards`` identical per-shard blocks laid out by
    one shared ``local_classes`` table; state rows are shard blocks of
    ``n_blk = n_per + growth_rows + 1``: ``n_per`` peers, ``growth_rows``
    reserved growth-capacity rows (degree 0, outside every class, born
    non-existent) and one pad row, the last of which is the CSR sentinel.
    The plan's global ``classes`` are the per-shard tables shifted by the
    block offsets, so the local engine runs it unchanged; the pairing
    pipeline spans the whole global array. Peer id ``s * n_blk + j`` is
    shard ``s``'s j-th-lowest-degree peer. ``block_keys=True`` is the
    distributable derivation (``_build_plan``), the layout
    ``dist.builder.matching_powerlaw_graph_dist`` builds shard by shard."""
    s = n_shards
    if s < 1 or 128 % s:
        raise ValueError(
            f"n_shards={s} must divide 128 (the transpose all_to_all splits "
            "the lane axis)"
        )
    if growth_rows < 0:
        raise ValueError(f"growth_rows={growth_rows} must be >= 0")
    dev = resolve_device(device)
    if key is None:
        key = prng.key(0, dev)
    lay = sharded_layout(n, s, gamma, d_min, d_max, growth_rows)
    d_max, n_per = lay["d_max"], lay["n_per"]
    local_classes, per_rows = lay["local_classes"], lay["per_rows"]
    rows, n_blk, n_state = lay["rows"], lay["n_blk"], lay["n_state"]
    classes = tuple(
        (sh * n_blk + no, sh * per_rows * 128 + so, c, pd, cs)
        for sh in range(s)
        for (no, so, c, pd, cs) in local_classes
    )
    deg_state = np.zeros(n_state, dtype=np.int32)
    for sh in range(s):
        deg_state[sh * n_blk: sh * n_blk + n_per] = lay["deg_local"]
    layout = class_layout(classes, rows, n_state, dev)
    lanes, m3, lanes_inv, valid, deg_other, deg_real, row_ptr, col_idx = _build_plan(
        key.to(dev), torch.from_numpy(deg_state).to(dev), n=n_state, rows=rows, classes=classes,
        layout=layout, export_csr=export_csr, sentinel=n_state - 1, int8_tables=lay["int8_tables"],
        deg_cap=d_max, block_keys=block_keys, n_shards=s, n_blk=n_blk,
    )
    plan = MatchingPlan(
        lanes=lanes, m3=m3, lanes_inv=lanes_inv, valid=valid,
        deg_other=deg_other, deg_real=deg_real, n=n_state, rows=rows, classes=classes,
        fanout=fanout, mesh_shards=s, n_per=n_per, n_blk=n_blk, per_rows=per_rows,
        local_classes=local_classes, layout=layout,
    )
    exists = (torch.arange(n_state, device=dev) % n_blk) < n_per
    return DeviceGraph(row_ptr=row_ptr, col_idx=col_idx, exists=exists, n=n_state - 1), plan
