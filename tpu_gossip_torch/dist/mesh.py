"""The bucketed sharded engine: peers 1-D sharded over a mesh of shards.

Ports the bucketed half of ``tpu_gossip/dist/mesh.py``. On the host, once
per graph: :func:`partition_graph` relabels the peers with a load-balance
permutation and files every directed edge under its (source shard,
destination shard) bucket, padded to one capacity B (whole 1024-entry
windows), each bucket sorted by destination row; :func:`build_shard_plans`
turns each destination shard's received runs into K6's tile tables. Each
round, :func:`gossip_round_dist` draws the per-edge activation of every
shard, gathers the senders' packed words into the (S, S, B) payload,
exchanges it, bills it and receives it: with a plan through K6
(``kernels/pallas_segment.py::stream_segment_or``, one launch per shard and
32-slot group), without one through the scatter OR. The two receives give
the same bits, so a run is digest-equal either way. Everything after
delivery is the local engine's ``advance_round``.

The JAX package runs the round per shard inside ``shard_map`` over a
device mesh and exchanges with ``all_to_all``. Here the mesh is
:class:`Mesh`: S shards in one process on one device, with the shard
axis written out as a leading dimension. Shard ``s``'s payload row ``d``
is what it sends shard ``d``, so the exchange is the (S_src, S_dst)
transpose of the stacked payload, and shard ``s``'s draws come from its
own key exactly as the JAX package derives it. Under churn re-wiring a
rewired sender's static out-edges carry nothing, deliveries to a rewired
row over static edges are dropped before billing, and the rejoiners'
fresh edges go through the local engine's ``fresh_rewire_traffic`` over
the mesh's global state. :func:`repartition_swarm` is the epoch rebuild
after a CSR fold; it moves the delay buffer (``fault_held``) with its
rows. A ``scenario`` (``faults/``) wraps the delivery exactly as on the
local engine, its masks compiled over the padded slot space through
``position`` (:func:`shard_ranges` for whole-shard sets), so a scenario
run equals the local run of the same engine family bit for bit, and so
does a run under the quorum detector (``liveness``) with its adversaries,
and a growing run (``growth``, its admission rows mapped through
``position``): the admission draws at global shape, as on the local
engine, and so does a streamed run (``stream``, its origin rows mapped
through ``position``) and a controlled one (``control``: the round's
effective fanout and pull gate enter every shard's activation, the needy
rows filter the pull direction receiver-side, and the refresh draws at
global shape). A pipelined round (``pipeline`` at depth 1) delivers the
exchange the round before issued and stores its own in ``pipe_buf``, as
the local engine does. ``transport`` (``dist/transport.py``) moves a
round's exchange through the compact lane wherever its header proves the
budget holds, and ``collect_ici`` appends the round's analytic ICI word
counters. A ``MatchingPlan`` in place of the graph runs the sharded
matching engine (``dist/matching_mesh.py``).

The mesh (``cluster/topology.py::Mesh``) folds its shards into (hosts,
devices) rows. A ``hier`` transport runs the exchange in two stages, the
device stage inside each host row and the compacted host stage between
rows (``cluster/hier.py``). Under ``torch.distributed`` each process is one
host row and holds only its rows of every table and plane
(:func:`shard_graph`, :func:`shard_plans`, :func:`shard_swarm`): the
exchange crosses the process group, a shard's draws come from its own key
as before, and the whole-swarm numbers (the round's stats, the coverage,
the lane gates, the ICI counters) are summed or maximised over the
processes, so every process carries the same stats. The row planes'
cross-row side paths (churn's endpoints and credit, the fresh edges'
traffic, the flood replay, the forged heartbeats, the accusations) take
the process's block of rows (``cluster.topology.row_block``, a
``core.rows.Rows``) from :func:`gossip_round_dist`: each draw is the
block of the swarm's draw, each read at another process's rows goes
through a gathered plane and each write lands on its holder by the
one-process scatter's own OR, integer SUM or MAX, and the scenario's row
masks are cut to the block (``CompiledScenario.rows``), so a run is the
one-process fold's bit for bit. :func:`gather_swarm` joins the rows again.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from tpu_gossip_torch.cluster.topology import (Mesh, exchange_blocks, local_shards, reduce_max, reduce_sum, row_block,
                                               world)
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.core.packed import is_packed, pack_bits, packed_width, unpack_bits, words8_to_words32
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState, init_swarm
from tpu_gossip_torch.core.topology import Graph, build_csr
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.packed_ops import popcount_rows
from tpu_gossip_torch.kernels.pallas_segment import TILE, _pad_tiles, _slot_groups, stream_segment_or, unpack_words
from tpu_gossip_torch.sim.engine import _ratio, fresh_rewire_traffic
from tpu_gossip_torch.sim.stages import not_ported, run_protocol_round

__all__ = [
    "Mesh",
    "ShardedGraph",
    "ShardPlans",
    "make_mesh",
    "partition_graph",
    "build_shard_plans",
    "init_sharded_swarm",
    "shard_graph",
    "shard_plans",
    "shard_swarm",
    "gather_swarm",
    "reduce_stats",
    "swarm_coverage",
    "repartition_swarm",
    "shard_ranges",
    "gossip_round_dist",
    "simulate_dist",
    "run_until_coverage_dist",
    "dense_wire_words",
    "all_to_all",
]

def make_mesh(n_shards: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A flat mesh of ``n_shards`` shards on ``device``. ``None`` is
    :func:`~tpu_gossip_torch.cluster.topology.local_shards` shards a
    process (one unless the launcher says otherwise) over every process of
    the ``torch.distributed`` group; several processes make one host row
    each."""
    from tpu_gossip_torch.cluster.topology import make_cluster_mesh

    dev = resolve_device(device)
    w = world()
    if n_shards is None:
        n_shards = local_shards() * w
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    return make_cluster_mesh(n_shards, hosts=w, device=dev)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """The bucket routing tables, (S, S, B) each: ``send_src[s, d, b]`` is
    the sender-local row of the b-th edge from shard ``s`` to shard ``d``
    (pad: 0 with ``send_valid`` False), ``recv_dst[d, s, b]`` the
    receiver-local row of the same edge, indexed the way shard ``d`` reads
    its exchange result; ``send_dst_deg``/``send_src_deg`` the edge's
    destination and sender degrees (1 on pads); ``deg`` (n_pad,) each
    slot's degree. ``fingerprint`` is the crc32 of the receive tables."""

    send_src: torch.Tensor  # int32 (S, S, B)
    recv_dst: torch.Tensor  # int32 (S, S, B)
    send_valid: torch.Tensor  # bool (S, S, B)
    send_dst_deg: torch.Tensor  # int32 (S, S, B)
    send_src_deg: torch.Tensor  # int32 (S, S, B)
    deg: torch.Tensor  # int32 (n_pad,)
    n: int
    n_pad: int
    n_shards: int
    per_shard: int
    bucket: int
    fingerprint: int = 0
    shard_lo: int = 0

    @property
    def stacked(self) -> int:
        """Shards whose tables this process holds."""
        return int(self.send_src.shape[0])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def partition_graph(graph: Graph, n_shards: int, *, seed: int = 0, permute: bool = True, window: int = 1024,
                    device: str | torch.device = "cuda") -> tuple[ShardedGraph, Graph, np.ndarray]:
    """Partition a host graph for ``n_shards`` shards; returns
    ``(sharded_graph, relabeled_graph, position)``: the padded, permuted
    CSR (host numpy) and ``position[old_id] = slot``. Bucket capacity is
    the largest bucket rounded up to whole ``window``-entry windows
    (:func:`build_shard_plans` needs 1024; ``window=1`` for a scatter-only
    run). The tables go to ``device``."""
    dev = resolve_device(device)
    row_ptr, col_idx = _host(graph.row_ptr).astype(np.int64), _host(graph.col_idx)
    n, s = graph.n, n_shards
    per = math.ceil(n / s)
    n_pad = per * s
    rng = np.random.default_rng(seed)
    position = rng.permutation(n) if permute else np.arange(n)

    src = position[np.repeat(np.arange(n), np.diff(row_ptr))].astype(np.int64)
    dst = position[col_idx.astype(np.int64)]
    und = src < dst  # each undirected edge once, in relabeled ids
    relabeled = build_csr(n_pad, np.stack([src[und], dst[und]], axis=1))
    deg = (relabeled.row_ptr[1:] - relabeled.row_ptr[:-1]).astype(np.int32)

    gid = (src // per) * s + (dst // per)  # bucket id of each directed edge
    counts = np.bincount(gid, minlength=s * s)
    b = max(-(-max(int(counts.max()) if counts.size else 0, 1) // window) * window, window)
    # each bucket sorted by destination row: shard d's exchange result is
    # then S destination-sorted runs, which K6 streams window by window
    order = np.lexsort((dst, gid))
    gs, ss, ds = gid[order], src[order], dst[order]
    starts = np.zeros(s * s + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    k = np.arange(len(gs)) - starts[gs]

    send_src = np.zeros((s * s, b), dtype=np.int32)
    recv_dst = np.zeros((s * s, b), dtype=np.int32)
    send_valid = np.zeros((s * s, b), dtype=bool)
    send_dst_deg = np.ones((s * s, b), dtype=np.int32)
    send_src_deg = np.ones((s * s, b), dtype=np.int32)
    send_src[gs, k] = (ss - (gs // s) * per).astype(np.int32)
    recv_dst[gs, k] = (ds - (gs % s) * per).astype(np.int32)
    send_valid[gs, k] = True
    send_dst_deg[gs, k] = deg[ds]
    send_src_deg[gs, k] = deg[ss]
    # receiver d reads its exchange result by sender shard: (s, d) -> (d, s)
    recv_t = np.ascontiguousarray(recv_dst.reshape(s, s, b).transpose(1, 0, 2))
    valid3 = send_valid.reshape(s, s, b)

    def tab(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sg = ShardedGraph(
        send_src=tab(send_src.reshape(s, s, b)), recv_dst=tab(recv_t), send_valid=tab(valid3),
        send_dst_deg=tab(send_dst_deg.reshape(s, s, b)), send_src_deg=tab(send_src_deg.reshape(s, s, b)),
        deg=tab(deg), n=n, n_pad=n_pad, n_shards=s, per_shard=per, bucket=b,
        fingerprint=_routing_fingerprint(recv_t, valid3),
    )
    return sg, relabeled, position


def _routing_fingerprint(recv_dst: np.ndarray, send_valid: np.ndarray) -> int:
    """crc32 over the receive routing tables (host arrays)."""
    crc = zlib.crc32(np.ascontiguousarray(recv_dst, dtype=np.int32).tobytes())
    return zlib.crc32(np.ascontiguousarray(send_valid, dtype=np.uint8).tobytes(), crc)


@dataclasses.dataclass(frozen=True)
class ShardPlans:
    """K6's tables for each destination shard: one tile per (window,
    output block) incidence of its received runs, block-major, padded to
    one tile count T with inert tiles (block ``n_blocks - 1``, every
    ``offs`` -1). ``window_idx[d, t]`` is the 1024-entry window of shard
    ``d``'s flat exchange result that tile ``t`` reads; ``offs`` the row
    inside the tile's block of each window position, -1 outside the tile's
    (block, run) segment. The JAX plan's ``first_visit`` is not carried:
    K6's wrapper zeroes its outputs. The last four fields name the
    partition the tables index (:meth:`check_matches`)."""

    tile_block: torch.Tensor  # int32 (S, T)
    offs: torch.Tensor  # int32 (S, T*8, 128)
    window_idx: torch.Tensor  # int32 (S, T)
    per: int
    n_tiles: int
    n_blocks: int
    rows: int = 1024
    n_shards: int = 0
    bucket: int = 0
    fingerprint: int = 0

    def check_matches(self, sg: ShardedGraph) -> None:
        got = (self.per, self.n_shards, self.bucket, self.fingerprint)
        want = (sg.per_shard, sg.n_shards, sg.bucket, sg.fingerprint)
        if got != want:
            raise ValueError(
                f"shard_plan built for (per, shards, bucket, fingerprint)={got} but the graph has {want}: "
                "two partitions can share sizes yet route differently; rebuild with build_shard_plans(sg)"
            )


def build_shard_plans(sg: ShardedGraph, *, rows: int = 1024) -> ShardPlans:
    """K6's plans over each shard's receive side, on the host from the
    graph's tables, placed where the graph lies. Each received run is
    destination-sorted and window-aligned (:func:`partition_graph`), so a
    plan is bookkeeping: a window shared by two blocks gives two tiles with
    complementary ``offs`` masks. Built from every shard's tables (a
    process's own, :func:`shard_plans`, are cut from them)."""
    s, b, per = sg.n_shards, sg.bucket, sg.per_shard
    if sg.stacked != s:
        raise ValueError("build_shard_plans reads every shard's send tables: build the plans from the whole "
                         "partition, then shard_plans(plans, mesh)")
    if b % TILE != 0:
        raise ValueError(f"bucket capacity {b} is not window-aligned: partition the graph with "
                         f"partition_graph(..., window={TILE}) (the default)")
    n_blocks = max(1, -(-per // rows))
    recv_dst = _host(sg.recv_dst)  # (S_dst, S_src, B)
    recv_valid = _host(sg.send_valid).transpose(1, 0, 2)  # seen from the receiver
    cnts = recv_valid.sum(-1)  # (S_dst, S_src): valid entries lead each run
    w_per_run = b // TILE

    def shard_tiles(d):
        tb_parts, wi_parts, run_parts = [], [], []
        for r in range(s):
            cnt = int(cnts[d, r])
            if cnt == 0:
                continue
            dstr = recv_dst[d, r]
            nw = -(-cnt // TILE)  # windows with any valid entry
            w_ids = np.arange(nw)
            last = np.minimum((w_ids + 1) * TILE, cnt) - 1
            blk_lo = dstr[w_ids * TILE] // rows  # destination-sorted: the window's ends
            blk_hi = dstr[last] // rows  # bound its block span
            span = blk_hi - blk_lo + 1
            wrep = np.repeat(w_ids, span)
            koff = np.arange(len(wrep)) - np.repeat(np.cumsum(span) - span, span)
            tb_parts.append((np.repeat(blk_lo, span) + koff).astype(np.int32))
            wi_parts.append((r * w_per_run + wrep).astype(np.int32))
            run_parts.append(np.full(len(wrep), r, dtype=np.int32))
        empty = np.zeros(0, dtype=np.int32)
        tb_r = np.concatenate(tb_parts) if tb_parts else empty
        wi_r = np.concatenate(wi_parts) if wi_parts else empty
        run_r = np.concatenate(run_parts) if run_parts else empty
        # an inert tile for each block no run reaches
        missing = np.setdiff1d(np.arange(n_blocks, dtype=np.int32), tb_r)
        tb_all = np.concatenate([tb_r, missing])
        wi_all = np.concatenate([wi_r, np.zeros(len(missing), np.int32)])
        run_all = np.concatenate([run_r, np.full(len(missing), -1, np.int32)])
        order = np.lexsort((run_all, wi_all, tb_all))  # block-major
        tb_all, wi_all, run_all = tb_all[order], wi_all[order], run_all[order]
        dvals = recv_dst[d].reshape(s * w_per_run, TILE)[wi_all]  # (T_d, TILE)
        pos_in_run = (wi_all % w_per_run)[:, None] * TILE + np.arange(TILE)
        valid_pos = (run_all[:, None] >= 0) & (pos_in_run < cnts[d][np.maximum(run_all, 0)][:, None])
        offs_all = np.where(valid_pos & (dvals // rows == tb_all[:, None]), dvals - tb_all[:, None] * rows, -1)
        return tb_all, wi_all, offs_all.astype(np.int32)

    per_shard = [shard_tiles(d) for d in range(s)]
    T = _pad_tiles(max(len(t[0]) for t in per_shard))
    tb = np.full((s, T), n_blocks - 1, dtype=np.int32)
    wi = np.zeros((s, T), dtype=np.int32)
    offs = np.full((s, T, TILE), -1, dtype=np.int32)
    for d, (tb_d, wi_d, offs_d) in enumerate(per_shard):
        k = len(tb_d)
        tb[d, :k], wi[d, :k], offs[d, :k] = tb_d, wi_d, offs_d

    dev = sg.recv_dst.device
    return ShardPlans(
        tile_block=torch.from_numpy(tb).to(dev), offs=torch.from_numpy(offs.reshape(s, T * 8, 128)).to(dev),
        window_idx=torch.from_numpy(wi).to(dev), per=per, n_tiles=T, n_blocks=n_blocks, rows=rows,
        n_shards=s, bucket=b, fingerprint=sg.fingerprint,
    )


def init_sharded_swarm(sg: ShardedGraph, relabeled: Graph, position: np.ndarray, cfg: SwarmConfig, *,
                       key: torch.Tensor | None = None, origins=None, origin_slot: int = 0,
                       exists: np.ndarray | None = None, device: str | torch.device = "cuda") -> SwarmState:
    """SwarmState over the padded slot space on ``device``; pad slots are
    born dead (``alive`` and ``exists`` False, ``declared_dead`` True,
    ``join_round`` -1). ``cfg.n_peers`` must equal ``sg.n_pad``;
    ``origins`` and ``exists`` (length ``sg.n``) are over ORIGINAL peer
    ids and are mapped through ``position``."""
    if cfg.n_peers != sg.n_pad:
        raise ValueError(f"cfg.n_peers={cfg.n_peers} != n_pad={sg.n_pad}")
    mapped = None if origins is None else position[np.asarray(origins)]
    state = init_swarm(relabeled, cfg, key=key, origins=mapped, origin_slot=origin_slot, device=device)
    dead = np.zeros(sg.n_pad, dtype=bool)
    dead[sg.n:] = True
    if exists is not None:
        if np.asarray(exists).shape != (sg.n,):
            raise ValueError(f"exists covers {np.asarray(exists).shape} ids; the graph has {sg.n}")
        dead[position[np.flatnonzero(~np.asarray(exists))]] = True
    if dead.any():
        d = torch.from_numpy(dead).to(state.seen.device)
        state.exists = state.exists & ~d
        state.alive = state.alive & ~d
        state.declared_dead = state.declared_dead | d
        state.join_round = state.join_round.masked_fill(d, -1)
    return state


def repartition_swarm(state: SwarmState, n_shards: int, *, seed: int = 0
                      ) -> tuple[ShardedGraph, SwarmState, np.ndarray]:
    """Re-partition a live swarm's current CSR (its capacity tail
    trimmed) and move every per-peer plane through the new permutation into
    the padded slot space, pads born dead as in :func:`init_sharded_swarm`.
    Fresh targets and admitting peers are peer ids, so they map through the
    permutation too. Host-side, once an epoch; the tables and the state
    stay where the state lies. Returns ``(sg, new_state, position)``."""
    n = int(state.alive.shape[0])
    dev = state.alive.device
    e_real = int(state.row_ptr[-1])
    graph = Graph(n=n, row_ptr=_host(state.row_ptr).astype(np.int32),
                  col_idx=_host(state.col_idx)[:e_real].astype(np.int32))
    sg, relabeled, position = partition_graph(graph, n_shards, seed=seed, device=dev)
    pos = torch.as_tensor(position, dtype=torch.int64, device=dev)
    fills = {"declared_dead": True, "infected_round": -1, "rewire_targets": -1, "join_round": -1,
             "admitted_by": -1}

    def remap(name, x):
        out = torch.full((sg.n_pad,) + tuple(x.shape[1:]), fills.get(name, 0), dtype=x.dtype, device=dev)
        out[pos] = x
        return out

    def to_slot(ids):
        return torch.where(ids >= 0, pos[torch.clamp(ids, 0, n - 1).to(torch.int64)].to(ids.dtype), ids)

    state = dataclasses.replace(state, rewire_targets=to_slot(state.rewire_targets),
                                admitted_by=to_slot(state.admitted_by))
    updates = {
        f.name: remap(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
        if f.name not in ("row_ptr", "col_idx", "rng") and getattr(state, f.name).ndim >= 1
        and getattr(state, f.name).shape[0] == n
    }
    new_state = dataclasses.replace(
        state, row_ptr=torch.as_tensor(relabeled.row_ptr, device=dev).to(torch.int32),
        col_idx=torch.as_tensor(relabeled.col_idx, device=dev).to(torch.int32), **updates)
    return sg, new_state, position


def shard_ranges(n_shards: int, block: int, mesh: Mesh | None = None) -> list[tuple[int, int]]:
    """Per-shard ``[lo, hi)`` row ranges of the padded slot space: shard
    ``s`` owns rows ``[s * block, (s + 1) * block)``. With ``mesh``, its
    size must be ``n_shards``."""
    if n_shards < 1 or block < 1:
        raise ValueError(f"shard_ranges needs n_shards >= 1 and block >= 1, got ({n_shards}, {block})")
    if mesh is not None and int(mesh.size) != n_shards:
        raise ValueError(f"mesh has {int(mesh.size)} devices but the layout expects {n_shards} shards")
    return [(s * block, (s + 1) * block) for s in range(n_shards)]


def _rows_of(mesh: Mesh, n_rows: int) -> slice:
    """This process's rows of an ``n_rows`` plane laid out in ``mesh.size``
    equal shard blocks."""
    blk = n_rows // mesh.size
    return slice(mesh.lo * blk, (mesh.lo + mesh.local) * blk)


# the fields every process holds whole: the CSR, the per-slot leases, the
# controller's level, the key and the round; every other field is a
# per-peer plane, split into the processes' row blocks
_WHOLE_FIELDS = frozenset({"row_ptr", "col_idx", "slot_lease", "control_lvl", "rng", "round"})


def _per_peer_fields(state) -> list[str]:
    return [f.name for f in dataclasses.fields(state)
            if f.name not in _WHOLE_FIELDS and isinstance(getattr(state, f.name), torch.Tensor)]


def shard_swarm(state, mesh: Mesh):
    """The state (SwarmState or PackedSwarm) on the mesh's device; the
    shards are row ranges of ``per_shard`` rows. On a multi-process mesh
    each per-peer plane keeps this process's rows only (the CSR, the key
    and the per-slot planes stay whole, as the JAX package replicates
    them)."""
    n = int(state.seen.shape[0])
    rows = _rows_of(mesh, n) if mesh.world > 1 else slice(None)
    planes = {name: getattr(state, name)[rows] for name in _per_peer_fields(state)}
    planes.update({name: getattr(state, name) for name in _WHOLE_FIELDS})
    return dataclasses.replace(state, **{name: x.to(mesh.device) for name, x in planes.items()})


def gather_swarm(state, mesh: Mesh):
    """The whole state on every process from each one's rows (the inverse
    of :func:`shard_swarm`, the JAX CLI's ``_gather_global``); the state
    itself on a one-process mesh."""
    if mesh.world == 1:
        return state
    from tpu_gossip_torch.cluster.topology import gather_rows

    return dataclasses.replace(state, **{name: gather_rows(getattr(state, name)) for name in _per_peer_fields(state)})


def shard_graph(sg: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """The routing tables on the mesh's device; on a multi-process mesh
    each process keeps its shards' rows: its (D, S, B) send and receive
    tables and its rows of ``deg``."""
    if sg.n_shards != mesh.size:
        raise ValueError(f"graph partitioned for {sg.n_shards} shards but the mesh has {mesh.size}")
    mine = slice(mesh.lo, mesh.lo + mesh.local) if mesh.world > 1 else slice(None)

    def put(t):
        return t[mine].to(mesh.device)

    return dataclasses.replace(
        sg, send_src=put(sg.send_src), recv_dst=put(sg.recv_dst), send_valid=put(sg.send_valid),
        send_dst_deg=put(sg.send_dst_deg), send_src_deg=put(sg.send_src_deg),
        deg=sg.deg[_rows_of(mesh, sg.n_pad) if mesh.world > 1 else slice(None)].to(mesh.device),
        shard_lo=mesh.lo if mesh.world > 1 else 0)


def shard_plans(plans: ShardPlans | None, mesh: Mesh) -> ShardPlans | None:
    """K6's plans on the mesh's device; on a multi-process mesh each
    process keeps its shards' plans."""
    if plans is None:
        return None
    mine = slice(mesh.lo, mesh.lo + mesh.local) if mesh.world > 1 else slice(None)
    return dataclasses.replace(plans, tile_block=plans.tile_block[mine].to(mesh.device),
                               offs=plans.offs[mine].to(mesh.device), window_idx=plans.window_idx[mine].to(mesh.device))


def swarm_coverage(state, slot: int = 0) -> torch.Tensor:
    """``state.coverage(slot)`` over the whole swarm: on a process of a
    multi-process mesh from the two counts summed over the processes (the
    same float32 ratio of the same integers)."""
    if world() == 1:
        return state.coverage(slot)
    from tpu_gossip_torch.core.packed import bit_column, is_packed, unpack_flag

    if is_packed(state):
        live = unpack_flag(state.flags, "alive") & ~unpack_flag(state.flags, "declared_dead")
        seen = bit_column(state.seen, slot)
    else:
        live = state.alive & ~state.declared_dead
        seen = state.seen[:, slot]
    # graftlint: disable=round-host-sync -- multi-process meshes only: the two coverage counts come back once a round after one all-reduce
    hit, n_live = reduce_sum(torch.stack([(seen & live).sum(), live.sum()])).tolist()
    return torch.tensor(hit, dtype=torch.float32) / torch.tensor(max(n_live, 1), dtype=torch.float32)


# the RoundStats columns a process counts over its own rows: the static
# round's, the fault plane's, the quorum detector's and the controller's
# refreshes (each a count of the process's rows or of its rows' sends, so
# the sum over the processes is the swarm's, counted once), and the
# per-slot live infected track. Every other column arrives whole: the
# stream's and the controller's level and fanout are the same on every
# process, and ``msgs_duplicate`` and ``degree_gamma`` are summed over the
# processes where the round computes them (the controller's decision
# reads the one, the growth plane's gamma is the other)
_ROW_SUMS = ("msgs_sent", "n_infected", "n_alive", "n_declared_dead", "n_members", "msgs_dropped", "msgs_held",
             "msgs_delivered", "evictions_new", "false_evictions", "n_quarantined", "dead_undeclared",
             "adv_accusations", "adv_forged", "control_refreshed", "slot_infected")


def reduce_stats(stats):
    """A round's RoundStats over the whole swarm: on a process of a
    multi-process mesh its row counts summed over the processes (one
    all-reduce) and the coverage taken from the sums, as
    ``SwarmState.coverage`` takes it."""
    if world() == 1:
        return stats
    cols = [getattr(stats, f).to(torch.int64).reshape(-1) for f in _ROW_SUMS]
    # graftlint: disable=round-host-sync -- multi-process meshes only: the summed row counts come back once a round after one all-reduce
    tot = reduce_sum(torch.cat(cols)).tolist()
    dev = stats.coverage.device
    sums, at = {}, 0
    for f, c in zip(_ROW_SUMS, cols):
        shape = getattr(stats, f).shape
        sums[f] = torch.tensor(tot[at: at + c.numel()], dtype=torch.int32, device=dev).reshape(shape)
        at += c.numel()
    # graftlint: disable=round-host-sync -- sums holds host-built tensors from the read above
    cov = (torch.tensor(int(sums["n_infected"]), dtype=torch.float32)
           # graftlint: disable=round-host-sync -- sums holds host-built tensors from the read above
           / torch.tensor(max(int(sums["n_alive"]), 1), dtype=torch.float32))
    return stats._replace(coverage=cov.to(dev), **sums)


# ------------------------------------------------------------ the exchange


def _uniform_rows(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Shard s's ``uniform(keys[s], shape)``, stacked along a leading S axis."""
    return torch.stack([prng.uniform(k, shape) for k in keys])


def shard_keys(sg: ShardedGraph, key: torch.Tensor) -> torch.Tensor:
    """One key a shard, ``split(key, S)``, for the shards whose tables
    ``sg`` holds."""
    return prng.split(key, sg.n_shards)[sg.shard_lo: sg.shard_lo + sg.stacked]


def activation(sg: ShardedGraph, keys: torch.Tensor, kind: str, fanout, pull_gate=None):
    """Each bucket entry's firing, (S, S, B) bool, and on the merged
    push_pull path the per-direction billing byte (uint8, bit 0 push, bit
    1 pull), else None. ``keys`` holds one key per shard; shard ``s``
    draws its (S, B) row of uniforms from its own key (the merged path
    splits it into a push and a pull key first). ``fanout`` is an int or
    the controller's effective fanout (int32 0-d), entering the push law
    ``fanout / max(src_deg, 1)``; ``pull_gate`` (bool 0-d) masks the pull
    activation."""
    s, b = sg.n_shards, sg.bucket
    valid = sg.send_valid
    if kind == "flood":
        return valid, None
    if kind == "push":
        return valid & (_uniform_rows(keys, (s, b)) < _ratio(fanout, sg.send_src_deg)), None
    if kind == "pull":
        act_q = valid & (_uniform_rows(keys, (s, b)) < _ratio(1, sg.send_dst_deg))
        return (act_q if pull_gate is None else act_q & pull_gate), None
    if kind != "push_pull":
        raise ValueError(f"unknown activation {kind!r}")
    kpq = torch.stack([prng.split(k) for k in keys])  # (S, 2, 2)
    act_p = valid & (_uniform_rows(kpq[:, 0], (s, b)) < _ratio(fanout, sg.send_src_deg))
    act_q = valid & (_uniform_rows(kpq[:, 1], (s, b)) < _ratio(1, sg.send_dst_deg))
    if pull_gate is not None:
        act_q = act_q & pull_gate
    return act_p | act_q, act_p.to(torch.uint8) | (act_q.to(torch.uint8) << 1)


def _shard_base(sg: ShardedGraph, device) -> torch.Tensor:
    """(S, 1, 1) int64 first row of each shard held, in the held rows."""
    return (torch.arange(sg.stacked, dtype=torch.int64, device=device) * sg.per_shard).view(-1, 1, 1)


def payload_words(transmit: torch.Tensor, sg: ShardedGraph) -> torch.Tensor:
    """(S_src, S_dst, B, W) uint8: each bucket entry's sender's packed
    words (``pack_bits``, the byte wire), before activation."""
    words = pack_bits(transmit)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    rows = (sg.send_src.to(torch.int64) + _shard_base(sg, words.device)).view(-1)
    return words.index_select(0, rows).view(*sg.send_src.shape, words.shape[1])


def send_payload(vals: torch.Tensor, active: torch.Tensor, acts) -> torch.Tensor:
    """The (S_src, S_dst, B, W[+1]) uint8 payload: each entry's sender's
    packed words (``vals``, :func:`payload_words`) where it fires, else 0;
    the billing byte appended on the merged path."""
    payload = torch.where(active[..., None], vals, 0)
    if acts is not None:
        payload = torch.cat([payload, acts[..., None]], dim=-1)
    return payload


def all_to_all(payload: torch.Tensor) -> torch.Tensor:
    """The exchange: shard d receives ``received[d, s] = payload[s, d]``.
    ``payload`` is (L_src, G_dst, ...): the L of G shards (or hosts) this
    process holds, each with one block a destination; the result is (L_dst,
    G_src, ...). With all G held it is the stacked transpose; else the G / L
    processes each send their (L, G, ...) block laid out by destination
    process (``cluster.topology.exchange_blocks``)."""
    l, g = payload.shape[:2]
    if l == g:
        return payload.transpose(0, 1).contiguous()
    rest = tuple(payload.shape[2:])
    send = payload.reshape(l, g // l, l, *rest).transpose(0, 1)  # (W_dst, L_src, L_dst, ...)
    recv = exchange_blocks(send)  # (W_src, L_src, L_dst, ...)
    return recv.permute(2, 0, 1, *range(3, recv.dim())).reshape(l, g, *rest).contiguous()


def bill(received: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(payload words, int64 message count) of a received buffer: the
    delivered bits, each counted once per direction that fired on the
    merged wire (its billing byte at column ``w``)."""
    # graftlint: disable=mem-widening-cast -- message counts sum in int64; the stats narrow them to int32
    pc = popcount_rows(received[..., :w]).to(torch.int64)
    if received.shape[-1] == w:
        return received, pc.sum()
    acts = received[..., w].to(torch.int64)
    return received[..., :w], (pc * ((acts & 1) + ((acts >> 1) & 1))).sum()


def receive(received: torch.Tensor, sg: ShardedGraph, shard_plan, m: int) -> torch.Tensor:
    """(n_pad, m) bool incoming: the OR of every received entry's words
    into its destination row. With a plan through K6, one launch per shard
    and 32-slot group over the shard's flat result; without one, the
    scatter OR (``index_add_`` of the bits, tested against zero)."""
    s, b, per, held = sg.n_shards, sg.bucket, sg.per_shard, sg.stacked
    if shard_plan is None:
        bits = unpack_bits(received, m).reshape(-1, m).to(torch.int32)
        rows = (sg.recv_dst.to(torch.int64) + _shard_base(sg, received.device)).view(-1)
        hits = torch.zeros((held * per, m), dtype=torch.int32, device=received.device)
        return hits.index_add_(0, rows, bits) > 0
    out = []
    for d in range(held):
        flat32 = words8_to_words32(received[d]).reshape(s * b, -1)
        groups = [
            unpack_words(stream_segment_or(shard_plan.tile_block[d], shard_plan.window_idx[d],
                                           shard_plan.offs[d], flat32[:, gi].contiguous(),
                                           shard_plan.rows, shard_plan.n_blocks)[:per], width)
            for gi, (_, width) in enumerate(_slot_groups(m))
        ]
        out.append(groups[0] if len(groups) == 1 else torch.cat(groups, dim=1))
    return out[0] if held == 1 else torch.cat(out)


def _received_rows(sg: ShardedGraph, rows: torch.Tensor, device) -> torch.Tensor:
    """A per-row (n_pad,) bool read at every received entry's destination
    row, shaped like ``recv_dst``."""
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    dst = (sg.recv_dst.to(torch.int64) + _shard_base(sg, device)).view(-1)
    return rows[dst].view(sg.recv_dst.shape)


def drop_blocked(received: torch.Tensor, sg: ShardedGraph, blocked_rows: torch.Tensor) -> torch.Tensor:
    """The receiver-side stale filter: every received entry bound for a
    ``blocked_rows`` row (a rewired slot, whose static in-edges are the
    departed occupant's) zeroed, billing byte included, before billing."""
    keep = ~_received_rows(sg, blocked_rows, received.device)
    return torch.where(keep[..., None], received, 0)


def drop_sated_pulls(received: torch.Tensor, sg: ShardedGraph, needy_rows: torch.Tensor, w: int) -> torch.Tensor:
    """The needy-pull gate on the merged wire: a sated puller issued no
    request, so the pull bit of every entry bound for a row outside
    ``needy_rows`` is cleared before billing; the words stay (their push
    direction is untouched)."""
    acts = received[..., w]
    received = received.clone()
    received[..., w] = torch.where(_received_rows(sg, needy_rows, received.device), acts, acts & 1)
    return received


def dense_wire_words(sg: ShardedGraph, m: int, mode: str, forward_once: bool = False,
                     bool_planes: bool = False) -> int:
    """The bucketed engine's wire declaration: the global dense exchange
    words of one fault-free round (the merged push_pull wire carries one
    billing byte more; the split path two exchanges). ``bool_planes``
    prices one byte a slot."""
    from tpu_gossip_torch.dist.transport import bucketed_dense_exchange_words

    s, b = sg.n_shards, sg.bucket
    w = m if bool_planes else packed_width(m)
    if mode in ("push", "flood"):
        return bucketed_dense_exchange_words(s, b, w)
    if mode != "push_pull":
        raise ValueError(f"unknown mode {mode!r}")
    if not forward_once:
        return bucketed_dense_exchange_words(s, b, w + 1)
    return 2 * bucketed_dense_exchange_words(s, b, w)


def _compact_exchange(payload: torch.Tensor, occ: torch.Tensor, cap: int) -> torch.Tensor:
    """The bucketed compact lane: each (source, destination) row's occupied
    entries gathered to ``cap`` with their index plane, both exchanged,
    and scattered back into the dense receive buffer the dense lane gives."""
    from tpu_gossip_torch.dist.transport import compact_index, gather_compact, scatter_compact

    l, g, b = occ.shape
    idx = compact_index(occ.reshape(l * g, b), cap)
    cvals = gather_compact(payload.reshape((l * g, b) + tuple(payload.shape[3:])), idx)
    idx_r = all_to_all(idx.view(l, g, cap)).view(l * g, cap)
    cvals_r = all_to_all(cvals.view((l, g, cap) + tuple(cvals.shape[2:]))).view(cvals.shape)
    return scatter_compact(idx_r, cvals_r, b).view(payload.shape)


def _exchange(transmit: torch.Tensor, sg: ShardedGraph, keys: torch.Tensor, kind: str, fanout,
              shard_plan=None, blocked_rows=None, rctl=None, transport=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One bucketed exchange; returns (incoming (n_pad, m) bool, int64
    messages). ``kind`` is the activation: push, pull, flood or the merged
    push_pull, which carries both directions on one wire. Deliveries to
    ``blocked_rows`` are neither delivered nor billed. ``rctl`` (the
    controller's round decision) puts ``m_eff`` in the push law and
    ``pull_on`` on the pull activation, and on the merged wire bills no
    pull of a sated row. An active ``transport`` takes the compact lane
    when the header (each (source, destination) row's entries whose
    sender's words are nonzero, read before activation, so no draw moves)
    fits its budget on every row; the receive buffer is the dense one."""
    m = transmit.shape[1]
    w = packed_width(m)
    if rctl is not None:
        fanout = rctl.m_eff
    active, acts = activation(sg, keys, kind, fanout, None if rctl is None else rctl.pull_on)
    vals = payload_words(transmit, sg)
    payload = send_payload(vals, active, acts)
    if transport is not None and transport.hier:
        from tpu_gossip_torch.cluster.hier import bucketed_hier_exchange

        # pre-activation occupancy; each post-device-stage row's count is a
        # host's entries for one destination shard, maximised everywhere
        occ = sg.send_valid & (vals != 0).any(-1)
        hrow = occ.sum(-1).view(-1, sg.n_shards // transport.hosts, sg.n_shards).sum(1)
        # graftlint: disable=round-host-sync -- the hier lane is picked on the host a round (JAX's lax.cond); parked perf item
        fits = bool(reduce_max(hrow.max()) <= transport.dcn_budget)
        received = bucketed_hier_exchange(payload, transport.hosts, transport.dcn_budget, fits, w)
    elif transport is not None and transport.active:
        occ = sg.send_valid & (vals != 0).any(-1)
        # graftlint: disable=round-host-sync -- the compact lane is picked on the host a round (JAX's lax.cond); parked perf item
        fits = bool(reduce_max(occ.sum(-1).max()) <= transport.budget)
        received = _compact_exchange(payload, occ, transport.budget) if fits else all_to_all(payload)
    else:
        received = all_to_all(payload)
    if blocked_rows is not None:
        received = drop_blocked(received, sg, blocked_rows)
    if kind == "push_pull" and rctl is not None and rctl.needy is not None:
        received = drop_sated_pulls(received, sg, rctl.needy, w)
    received, msgs = bill(received, w)
    return receive(received, sg, shard_plan, m), msgs


def _disseminate_bucketed(state, cfg: SwarmConfig, sg: ShardedGraph, shard_plan, transmit, transmitter,
                          receptive, k_push, k_pull, rctl=None, transport=None, rows=ALL_ROWS):
    """The bucketed engine's delivery; returns ``(incoming, msgs_sent)``.

    Both keys are split once more, child 0 driving delivery and child 1
    the re-wiring traffic, then into one key per shard. push_pull without
    forward_once is the merged path (one exchange, the pull answer being
    the push transmit); with it, a push and a pull exchange. Each pulling
    peer with neighbours bills one request. Under re-wiring (push and
    push_pull) rewired rows send nothing over static edges, receive
    nothing over them, bill no static pull, and their fresh edges carry
    ``fresh_rewire_traffic``; flood ignores re-wiring. Under a controller
    (``rctl``) the exchanges take its decision (:func:`_exchange`), a
    sated puller's pull exchange drops its deliveries like a stale edge's,
    and the pull requests are billed only where the pull half runs and
    only for needy rows. ``rows`` (``core.rows``) are the rows the state
    holds, which the fresh edges cross."""
    k_push, k_rw_push = prng.split(k_push)
    k_pull, k_rw_pull = prng.split(k_pull)
    rewiring = cfg.rewire_slots > 0 and cfg.mode in ("push", "push_pull")
    static_tx = transmit & ~state.rewired[:, None] if rewiring else transmit
    blocked = state.rewired if rewiring else None
    answer = state.seen & transmitter
    merged = cfg.mode == "push_pull" and not cfg.forward_once
    incoming = torch.zeros_like(state.seen)
    msgs = torch.zeros((), dtype=torch.int64, device=transmit.device)
    needy = None if rctl is None else rctl.needy
    if cfg.mode == "push_pull":
        pulls = (sg.deg > 0) & receptive.any(-1)
        if rewiring:
            pulls = pulls & ~state.rewired
        if needy is not None:
            pulls = pulls & needy
        pulls = pulls.sum()
        if rctl is not None:
            pulls = torch.where(rctl.pull_on, pulls, 0)
    if merged:
        inc, sent = _exchange(static_tx, sg, shard_keys(sg, k_push), "push_pull", cfg.fanout, shard_plan, blocked,
                              rctl, transport)
        incoming, msgs = incoming | inc, msgs + sent + pulls
    if cfg.mode in ("push", "push_pull") and not merged:
        # graftlint: disable=key-linearity -- the merged and split branches are exclusive: k_push feeds one of them
        inc, sent = _exchange(static_tx, sg, shard_keys(sg, k_push), "push", cfg.fanout, shard_plan, blocked, rctl,
                              transport)
        incoming, msgs = incoming | inc, msgs + sent
    if cfg.mode == "push_pull" and not merged:
        static_answer = answer & ~state.rewired[:, None] if rewiring else answer
        pull_blocked = blocked
        if needy is not None:
            pull_blocked = ~needy if blocked is None else blocked | ~needy
        inc, sent = _exchange(static_answer, sg, shard_keys(sg, k_pull), "pull", cfg.fanout, shard_plan,
                              pull_blocked, rctl, transport)
        incoming, msgs = incoming | inc, msgs + sent + pulls
    if cfg.mode == "flood":
        inc, sent = _exchange(transmit, sg, None, "flood", cfg.fanout, shard_plan, transport=transport)
        incoming, msgs = incoming | inc, msgs + sent
    if rewiring:
        inc, sent = fresh_rewire_traffic(state, cfg, transmit, answer, receptive.any(-1), k_rw_push, k_rw_pull,
                                         do_pull=cfg.mode == "push_pull", rctl=rctl, rows=rows)
        incoming, msgs = incoming | inc, msgs + sent
    return incoming, msgs.to(torch.int32)


def _disseminate_bucketed_packed(ps, cfg: SwarmConfig, sg: ShardedGraph, shard_plan, flags: dict, role_w, tx_w,
                                 k_push, k_pull, rctl=None, transport=None, rows=ALL_ROWS):
    """The packed round's delivery; returns ``(inc_w, msgs_sent)``. The
    exchange indexes rows of the bool planes, so the transmit and role
    words decode here, once a round, and the product packs again."""
    from tpu_gossip_torch.sim.packed_engine import _delivery_shim

    m = cfg.msg_slots
    shim = _delivery_shim(ps, flags, unpack_bits(ps.seen, m))
    role_b = unpack_bits(role_w, m)
    inc, msgs = _disseminate_bucketed(shim, cfg, sg, shard_plan, unpack_bits(tx_w, m), role_b, role_b, k_push,
                                      k_pull, rctl, transport, rows)
    return pack_bits(inc), msgs


# ---------------------------------------------------------------- the round


def _check_round(state, cfg: SwarmConfig, sg, mesh: Mesh, shard_plan, transport) -> None:
    """Refuse what does not fit."""
    if sg.n_shards != mesh.size:
        raise ValueError(f"graph partitioned for {sg.n_shards} shards but the mesh has {mesh.size}: "
                         f"repartition with partition_graph(g, {mesh.size})")
    if sg.stacked != mesh.local:
        raise ValueError(f"the graph's tables hold {sg.stacked} shards but this process holds {mesh.local}: "
                         "shard_graph(sg, mesh)")
    if state.seen.device != mesh.device:
        raise ValueError(f"state lies on {state.seen.device} but the mesh is on {mesh.device}: shard_swarm it")
    if shard_plan is not None:
        shard_plan.check_matches(sg)
    if transport is not None:
        transport.check_matches_graph(sg)
        transport.check_hosts(mesh)


def gossip_round_dist(state, cfg: SwarmConfig, sg, mesh: Mesh, shard_plan: ShardPlans | None = None, *,
                      transport=None, collect_ici: bool = False, **planes):
    """One sharded round: the bucketed exchange, then the local engine's
    stages; returns ``(new_state, RoundStats)``, with ``collect_ici`` the
    round's :class:`~tpu_gossip_torch.dist.transport.IciRound` third. With
    ``shard_plan`` the receive runs K6, else the scatter OR. A
    ``MatchingPlan`` in place of ``sg`` runs the sharded matching engine
    (``dist/matching_mesh.py``, bit-identical to the local matching round).
    A ``PackedSwarm`` runs the packed-native round, whose delivery decodes
    the transmit and role planes for the exchange and packs the product,
    and stays packed. ``transport`` takes the compact lane of each
    exchange its header lets through. ``planes`` are
    ``run_protocol_round``'s: ``scenario`` injects the round's faults
    around the exchange (and, on the packed round, around its bool twin);
    ``liveness`` (a ``QuorumSpec``) runs the quorum detector and the
    scenario's adversaries, their draws at global shape as on the local
    engine, ``growth`` admits the round's join batch and ``stream`` runs a
    streaming workload at global shape (its origin table in the mesh's
    rows), and ``control`` (a ``ControlSpec``, layout-blind) runs the
    adaptive controller, its decision riding every exchange. ``pipeline``
    (a ``PipelineSpec``) at depth 1 delivers the exchange the last round
    issued through the shard-local tail and carries this round's in
    ``pipe_buf``. ``inject`` (a serving batch) runs on the matching mesh,
    which the JAX CLI serves from; on this engine it raises
    ``NotImplementedError``."""
    if isinstance(sg, MatchingPlan) and shard_plan is not None:
        raise ValueError("shard_plan is the bucketed CSR engine's staircase receive; matching delivery has no "
                         "scatter to replace — pass shard_plan=None")
    n = int(state.seen.shape[0])
    rows = row_block(mesh, n)
    planes = dict(planes, rows=rows)
    if planes.get("scenario") is not None:
        planes["scenario"] = planes["scenario"].rows(rows.lo, rows.lo + n)
    if isinstance(sg, MatchingPlan):
        from tpu_gossip_torch.dist.matching_mesh import gossip_round_dist_matching

        out = gossip_round_dist_matching(state, cfg, sg, mesh, transport=transport, collect_ici=collect_ici, **planes)
    else:
        out = _gossip_round_bucketed(state, cfg, sg, mesh, shard_plan, transport, collect_ici, planes)
    return (out[0], reduce_stats(out[1]), *out[2:])


def _gossip_round_bucketed(state, cfg: SwarmConfig, sg, mesh: Mesh, shard_plan, transport, collect_ici: bool,
                           planes: dict):
    _check_round(state, cfg, sg, mesh, shard_plan, transport)
    if planes.get("inject") is not None:
        raise not_ported("the inject argument on the bucketed sharded engine (run_sim serve --shard runs the "
                         "matching mesh)", "bucketed-engine serving")
    if is_packed(state):
        from tpu_gossip_torch.sim.packed_engine import _delivery_shim, run_protocol_round_packed

        def deliver_words(tx_w, role_w, flags, kp, kq, rctl):
            return _disseminate_bucketed_packed(state, cfg, sg, shard_plan, flags, role_w, tx_w, kp, kq, rctl,
                                                transport, planes["rows"])

        def deliver_bool_factory(flags, seen_b):
            shim = _delivery_shim(state, flags, seen_b)

            def deliver(tx, tr, rc, kp, kq, rctl):
                return _disseminate_bucketed(shim, cfg, sg, shard_plan, tx, tr, rc, kp, kq, rctl, transport,
                                             planes["rows"])

            return deliver

        out = run_protocol_round_packed(state, cfg, deliver_words, deliver_bool_factory, **planes)
        if not collect_ici:
            return out
        return (*out, _ici_bucketed_packed(state, cfg, sg, transport, planes.get("scenario"), mesh))

    def disseminate(tx, tr, rc, kp, kq, rctl):
        return _disseminate_bucketed(state, cfg, sg, shard_plan, tx, tr, rc, kp, kq, rctl, transport, planes["rows"])

    out = run_protocol_round(state, cfg, disseminate, **planes)
    if not collect_ici:
        return out
    from tpu_gossip_torch.sim.stages import effective_transmit_planes

    # the fault-free single-pass model on the round's issued (post-blackout) plane
    tx_eff, transmitter, _ = effective_transmit_planes(state, cfg, planes.get("scenario"))
    return (*out, _ici_bucketed(state, cfg, sg, transport, tx_eff, transmitter, mesh))


def _ici_bucketed(state, cfg: SwarmConfig, sg: ShardedGraph, transport, transmit, transmitter, mesh: Mesh):
    """The analytic counter's view of one bucketed round: the plane masks
    the exchange applies, reduced to per-row nonzero indicators."""
    from tpu_gossip_torch.dist.transport import ici_round_bucketed

    rewiring = cfg.rewire_slots > 0 and cfg.mode in ("push", "push_pull")
    merged = cfg.mode == "push_pull" and not cfg.forward_once
    tx_any, ans_any = transmit.any(-1), None
    if cfg.mode != "flood":
        if rewiring:
            tx_any = tx_any & ~state.rewired
        if cfg.mode == "push_pull" and not merged:
            ans_any = (state.seen & transmitter).any(-1)
            if rewiring:
                ans_any = ans_any & ~state.rewired
    return ici_round_bucketed(sg, transport, packed_width(cfg.msg_slots), tx_any, ans_any, merged, mesh.hosts)


def _ici_bucketed_packed(ps, cfg: SwarmConfig, sg: ShardedGraph, transport, scenario, mesh: Mesh):
    """:func:`_ici_bucketed` off the packed words (the head without the
    quarantine mask, as the fault-free model reads transmit)."""
    from tpu_gossip_torch.dist.transport import ici_round_bucketed
    from tpu_gossip_torch.kernels import packed_ops as po
    from tpu_gossip_torch.sim.packed_engine import _decode_flags, packed_round_head

    flags = _decode_flags(ps)
    _, role_w, tx_w = packed_round_head(ps, cfg, flags, None)
    if scenario is not None and scenario.has_blackout:
        tx_w = po.mask_rows(tx_w, ~scenario.at_round(ps.round + 1).blackout)
    rewiring = cfg.rewire_slots > 0 and cfg.mode in ("push", "push_pull")
    merged = cfg.mode == "push_pull" and not cfg.forward_once
    tx_any, ans_any = po.rows_any(tx_w), None
    if cfg.mode != "flood":
        if rewiring:
            tx_any = tx_any & ~flags["rewired"]
        if cfg.mode == "push_pull" and not merged:
            ans_any = po.rows_any(po.and_words(ps.seen, role_w))
            if rewiring:
                ans_any = ans_any & ~flags["rewired"]
    return ici_round_bucketed(sg, transport, packed_width(cfg.msg_slots), tx_any, ans_any, merged, mesh.hosts)


def _stack_ici(rows: list):
    from tpu_gossip_torch.dist.transport import IciRound

    return IciRound(*(torch.stack([getattr(r, f) for r in rows]) for f in IciRound._fields))


def simulate_dist(state, cfg: SwarmConfig, sg, mesh: Mesh, num_rounds: int,
                  shard_plan: ShardPlans | None = None, *, collect_ici: bool = False, **planes):
    """A fixed horizon of sharded rounds; returns the final state and the
    per-round stats stacked along a leading (num_rounds,) axis; with
    ``collect_ici``, ``(state, (stats, ici))``, the counters stacked too."""
    from tpu_gossip_torch.sim.engine import _stack
    from tpu_gossip_torch.sim.stages import host_cursor, next_host_key

    r0, hkey = host_cursor(state, planes)
    rows, icis = [], []
    for i in range(num_rounds):
        out = gossip_round_dist(state, cfg, sg, mesh, shard_plan, collect_ici=collect_ici,
                                host_round=None if r0 is None else r0 + i, host_rng=hkey, **dict(planes))
        state, st = out[0], out[1]
        if collect_ici:
            icis.append(out[2])
        hkey = next_host_key(hkey)
        rows.append(st)
    if collect_ici:
        return state, (_stack(rows), _stack_ici(icis))
    return state, _stack(rows)


def run_until_coverage_dist(state, cfg: SwarmConfig, sg, mesh: Mesh, target: float = 0.99,
                            max_rounds: int = 1000, slot: int = 0, shard_plan: ShardPlans | None = None, *,
                            collect_ici: bool = False, **planes):
    """Sharded rounds until ``coverage(slot) >= target`` (compared in
    float32) or ``max_rounds``, reading the stop condition on the host once
    a round; rounds used = ``result.round - state.round``. With
    ``collect_ici``, ``(state, IciTotals)``: the counters summed over the
    rounds."""
    from tpu_gossip_torch.dist.transport import accumulate_ici, zero_ici_totals
    from tpu_gossip_torch.sim.stages import host_cursor, next_host_key

    start = state.round
    r0, hkey = host_cursor(state, planes)
    tgt = torch.tensor(target, dtype=torch.float32, device=state.seen.device)
    tot = zero_ici_totals(state.seen.device) if collect_ici else None
    s, i = state, 0
    # graftlint: disable=round-host-sync -- the coverage stop condition is read on the host once a round (JAX's while_loop)
    while bool((swarm_coverage(s, slot).to(tgt.device) < tgt) & (s.round - start < max_rounds)):
        out = gossip_round_dist(s, cfg, sg, mesh, shard_plan, collect_ici=collect_ici,
                                host_round=None if r0 is None else r0 + i, host_rng=hkey, **dict(planes))
        s = out[0]
        if collect_ici:
            tot = accumulate_ici(tot, out[2])
        hkey = next_host_key(hkey)
        i += 1
    return (s, tot) if collect_ici else s
