"""Structured-matching power-law topology: the gather-free graph family.

Ports the classic (single-layout) build of
``tpu_gossip/core/matching_topology.py``: ``quantile_degrees`` (:424),
``_plan_classes`` (:434), ``MatchingPlan`` (:218), ``pipeline_stages``,
``expand_classes``, ``reduce_classes``, ``_build_plan`` (:488, the
``block_keys=False`` derivation, with and without the CSR export) and
``matching_powerlaw_graph`` (:683). The sharded layouts belong to a later
slice.

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
(:class:`ClassLayout`); reduce folds each position-major class with
``fold_planes`` and the node-major classes with one index-add.
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
from tpu_gossip_torch.kernels.permute import apply_pipeline, fold_planes, inverse_tables
from tpu_gossip_torch.kernels.segment import bernoulli_threshold_device

__all__ = [
    "DEG_TABLE_CAP",
    "ClassLayout",
    "MatchingPlan",
    "class_layout",
    "expand_classes",
    "matching_powerlaw_graph",
    "pipeline_stages",
    "quantile_degrees",
    "reduce_classes",
]

DEG_TABLE_CAP = 2**15 - 1

# classes at or above this node count store slots position-major with
# 1024-aligned plane strides (folded by K2); smaller classes node-major
_POS_MAJOR_MIN = 8192


@dataclasses.dataclass(frozen=True)
class ClassLayout:
    """Index tables of a class layout (plan-time, derived from ``classes``).

    ``slot_node`` (rows*128,) int32 is the node each slot broadcasts from,
    ``n`` for dead slots (alignment gaps, stride padding, the tail), which
    read as 0. ``nm_slots``/``nm_owner`` list the node-major classes' slots
    and their nodes for the index-add reduce.
    """

    n: int
    slot_node: torch.Tensor
    nm_slots: torch.Tensor
    nm_owner: torch.Tensor


def class_layout(classes: tuple, rows: int, n: int, device) -> ClassLayout:
    """The :class:`ClassLayout` of ``classes`` over ``rows`` slot rows."""
    slot_node = np.full(rows * 128, n, dtype=np.int32)
    nm_slots, nm_owner = [], []
    for node_off, slot_off, count, pad_deg, cstride in classes:
        ids = np.arange(node_off, node_off + count, dtype=np.int32)
        if count >= _POS_MAJOR_MIN:
            plane = np.full(cstride, n, dtype=np.int32)
            plane[:count] = ids
            slot_node[slot_off : slot_off + pad_deg * cstride] = np.tile(plane, pad_deg)
        else:
            run = np.repeat(ids, pad_deg)
            slot_node[slot_off : slot_off + count * pad_deg] = run
            nm_slots.append(np.arange(slot_off, slot_off + count * pad_deg, dtype=np.int32))
            nm_owner.append(run)
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int32)  # noqa: E731
    return ClassLayout(
        n=n,
        slot_node=torch.from_numpy(slot_node).to(device),
        nm_slots=torch.from_numpy(cat(nm_slots)).to(device),
        nm_owner=torch.from_numpy(cat(nm_owner)).to(device),
    )


@dataclasses.dataclass(frozen=True)
class MatchingPlan:
    """Static routing state for structured-matching delivery (the JAX
    field order). ``classes`` holds (node_off, slot_off, count, pad_deg,
    cstride) runs; lane tables are int8 (int32 on small plans); ``valid``
    marks slots that survived erasure; sampling gates are computed per
    round from ``deg_other``/``deg_real``. ``layout`` is the port's index
    view of ``classes``."""

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

    def with_fanout(self, fanout: int) -> "MatchingPlan":
        """Rebind the sampling fanout (gates are computed per round)."""
        if self.deg_other is None:
            raise ValueError("plan carries no partner degrees")
        return dataclasses.replace(self, fanout=fanout)

    def push_threshold(self, fanout: int | None = None) -> torch.Tensor:
        """Per-slot uint32 push gate (int64): B(fanout/deg(sender)), 0 off-edge."""
        f = self.fanout if fanout is None else fanout
        p = f / torch.clamp(self.deg_other, min=1).to(torch.float32)
        return torch.where(
            self.valid & (self.deg_other > 0), bernoulli_threshold_device(p), 0
        )

    def pull_threshold(self) -> torch.Tensor:
        """Per-slot uint32 pull gate (int64): B(1/deg(puller)), 0 off-edge."""
        deg_self = self.expand(self.deg_real)
        p = 1.0 / torch.clamp(deg_self, min=1).to(torch.float32)
        return torch.where(self.valid & (deg_self > 0), bernoulli_threshold_device(p), 0)

    @property
    def stages(self) -> tuple:
        """The pairing involution as a permute.apply_pipeline stage tuple."""
        return pipeline_stages(self.lanes, self.m3, self.lanes_inv)

    def partner(self, x: torch.Tensor) -> torch.Tensor:
        """out[j] = x[pi(j)] over (R, 128) int32 slot data: one pipeline pass."""
        return apply_pipeline(x, self.stages)

    def expand(self, x_n: torch.Tensor) -> torch.Tensor:
        """Broadcast per-node values (n,) onto slots (R, 128)."""
        return expand_classes(x_n, self.layout, self.rows)

    def reduce(self, slots: torch.Tensor, op: str = "or") -> torch.Tensor:
        """Fold slot values (R, 128) into per-node values (n,)."""
        return reduce_classes(slots, self.classes, self.layout, op)


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


def reduce_classes(slots: torch.Tensor, classes: tuple, layout: ClassLayout,
                   op: str = "or") -> torch.Tensor:
    """Fold slot values (rows, 128) into per-node values (layout.n,): each
    position-major class through ``fold_planes`` (K2), the node-major
    classes by one index-add (``op`` "or" folds each bit as a count)."""
    if op not in ("or", "sum"):
        raise ValueError(f"reduce op must be 'or' or 'sum', got {op!r}")
    n_out = layout.n
    out = torch.zeros((n_out,), dtype=slots.dtype, device=slots.device)
    for node_off, slot_off, count, pad_deg, cstride in classes:
        if count >= _POS_MAJOR_MIN:
            out[node_off : node_off + count] = fold_planes(slots, slot_off, cstride, count, pad_deg, op)
    if layout.nm_slots.numel():
        vals = slots.reshape(-1).index_select(0, layout.nm_slots)
        if op == "sum":
            out.index_add_(0, layout.nm_owner, vals)
        else:
            shifts = torch.arange(32, dtype=torch.int32, device=slots.device)
            bits = (vals[:, None] >> shifts) & 1
            counts = torch.zeros((n_out, 32), dtype=torch.int32, device=slots.device)
            counts.index_add_(0, layout.nm_owner, bits)
            words = ((counts > 0).to(torch.int64) << shifts.to(torch.int64)).sum(1)
            words = torch.where(words >= 2**31, words - 2**32, words).to(slots.dtype)
            out |= words
    return out


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
                deg_cap: int | None = None):
    """The classic plan derivation (JAX ``_build_plan`` with
    ``block_keys=False`` and the sentinel-row CSR)."""
    r = rows
    dev = deg.device
    n_stages = max(2, math.ceil(math.log(max(r, 2)) / math.log(128)))
    keys = prng.split(key, n_stages + 1)
    tdt = torch.int8 if r % 32 == 0 else torch.int32

    lanes = tuple(
        torch.argsort(prng.uniform(keys[i], (r, 128)), dim=1, stable=True).to(tdt)
        for i in range(n_stages)
    )
    p = torch.argsort(prng.uniform(keys[n_stages], (r, 128)), dim=1, stable=True)
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

    if export_csr:
        src = torch.where(valid.reshape(-1), owner.reshape(-1), n)
        dst = torch.where(valid.reshape(-1), other_owner.reshape(-1), n)
        csr_order = torch.argsort(src, stable=True)
        col_idx = dst[csr_order]
        row_ptr = torch.searchsorted(
            src[csr_order], torch.arange(n + 2, dtype=torch.int32, device=dev), side="left"
        ).to(torch.int32)
    else:
        row_ptr = torch.cat([
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.cumsum(deg_real, 0, dtype=torch.int32),
        ])
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
