"""The sharded matching engine: the gather-free pipeline on the mesh.

Ports ``tpu_gossip/dist/matching_mesh.py``. Under the per-shard layout of
``matching_powerlaw_graph_sharded`` every stage of the matching round is
shard-local but the transposes: the S shards each own ``n_blk`` state
rows and ``per_rows`` slot rows laid out by one ``local_classes`` table,
so the plan's global (R, 128) slot array is S stacked (per_rows, 128)
blocks and its global class table is ``local_classes`` repeated at the
shard offsets. On the one-process mesh the round is therefore the local
engine's round (``sim.engine.gossip_round``) on the plan with a
``MeshRoute``, which changes only the partner pass:

- expand: one gather over the stacked blocks;
- lane stages: one K1 launch over all S·per rows (the lane tables are row
  blocks of the global tables);
- transposes: one exchange each (``kernels/permute.py::
  transpose_pass_sharded``, or the transport's compact lanes);
- reduce: one K2 launch over the shard-major class table, every shard's
  fold at once, zeros on each shard's pad and growth rows.

The gates are the local engine's, drawn at the plan's global (R, 128)
shape, so a mesh round equals the local round on the same plan bit for
bit, under every plane the round composes. The packed round hands the
pipeline the state's uint8 words directly. Under the hier transport each
transpose runs two-level (``cluster/hier.py``).

Under ``torch.distributed`` a process holds only its D shards' rows
(:func:`shard_matching_plan`): its ``D·per_rows`` slot rows of every lane
table, ``valid`` and the degree tables, its ``D·n_blk`` state rows and the
class table over them. Its gates are its rows' block of the global draw
(``prng.bits``'s counter offset), its expand and reduce run over its own
class table, and the transposes cross the process group. The row planes
(churn and the fresh edges' side paths, faults, the quorum detector) take
the process's block of rows that ``dist/mesh.py::gossip_round_dist``
hands the local round (``rows``).
"""

from __future__ import annotations

import dataclasses
import types


from tpu_gossip_torch.core.matching_topology import MatchingPlan, MeshRoute
from tpu_gossip_torch.core.packed import is_packed, packed_width, unpack_bits
from tpu_gossip_torch.kernels import packed_ops as po

__all__ = ["dense_wire_words", "shard_matching_plan", "gossip_round_dist_matching"]


# graftlint: disable=mem-wire-drift -- K1 carries each 32-slot group as an int32 lane word, so at M <= 16 the transposes ship 32 bits a lane where this model (JAX's byte planes) counts 8 per byte group: 32768 words against 16384 at n=256, S=8, M=16 (ROADMAP section 3)
def dense_wire_words(plan: MatchingPlan, m: int, mode: str, forward_once: bool = False,
                     bool_planes: bool = False) -> int:
    """The matching engine's wire declaration: the global dense exchange
    words of one fault-free round (one (R, 128) byte plane a byte group a
    transpose stage; the pull direction ships its own plane only under
    ``forward_once``). ``bool_planes`` prices one byte plane a slot."""
    from tpu_gossip_torch.dist.transport import matching_dense_stage_words

    n_stages = sum(1 for st in plan.stages if st[0] in ("t", "tinv"))
    groups = m if bool_planes else packed_width(m)
    if mode not in ("push", "push_pull", "flood"):
        raise ValueError(f"unknown mode {mode!r}")
    apps = 2 if (mode == "push_pull" and forward_once) else 1
    return apps * groups * n_stages * matching_dense_stage_words(plan.mesh_shards * plan.per_rows)


def _check_layout(plan: MatchingPlan, mesh) -> None:
    if plan.mesh_shards != mesh.size:
        raise ValueError(f"plan laid out for {plan.mesh_shards} shards but mesh has {mesh.size} devices — rebuild "
                         f"with matching_powerlaw_graph_sharded(n, {mesh.size})")


def shard_matching_plan(plan: MatchingPlan, mesh) -> MatchingPlan:
    """The plan placed on the mesh: every table (its shard blocks stacked)
    and the class layout on the mesh's device. On a multi-process mesh the
    process keeps its shards' rows of each table and a class layout of its
    own over its state rows; a plan that holds them already (the
    distributed builder's) is only placed."""
    _check_layout(plan, mesh)
    if plan.rows != mesh.local * plan.per_rows:
        return _held_plan(plan, mesh)
    if plan.shard_lo != mesh.lo:
        raise ValueError(f"the plan holds shards from {plan.shard_lo} on but this process holds them from {mesh.lo}")

    def put(t):
        return None if t is None else t.to(mesh.device)

    lay = plan.layout
    return dataclasses.replace(
        plan, lanes=tuple(put(t) for t in plan.lanes), m3=put(plan.m3),
        lanes_inv=tuple(put(t) for t in plan.lanes_inv), valid=put(plan.valid), deg_other=put(plan.deg_other),
        deg_real=put(plan.deg_real),
        layout=None if lay is None else dataclasses.replace(lay, slot_node=put(lay.slot_node), table=put(lay.table),
                                                            work=put(lay.work)),
    )


def _held_plan(plan: MatchingPlan, mesh) -> MatchingPlan:
    from tpu_gossip_torch.core.matching_topology import class_layout
    from tpu_gossip_torch.dist.builder import held_classes

    lo, held, per, blk = mesh.lo, mesh.local, plan.per_rows, plan.n_blk
    rows, nodes = slice(lo * per, (lo + held) * per), slice(lo * blk, (lo + held) * blk)

    def put(t, part):
        return None if t is None else t[part].to(mesh.device)

    classes = held_classes(plan.local_classes, held, blk, per)
    return dataclasses.replace(
        plan, lanes=tuple(put(t, rows) for t in plan.lanes), m3=put(plan.m3, rows),
        lanes_inv=tuple(put(t, rows) for t in plan.lanes_inv), valid=put(plan.valid, rows),
        deg_other=put(plan.deg_other, rows), deg_real=put(plan.deg_real, nodes), n=held * blk, rows=held * per,
        classes=classes, layout=class_layout(classes, held * per, held * blk, mesh.device), shard_lo=lo)


def _routed(plan: MatchingPlan, transport) -> MatchingPlan:
    """The plan with its mesh route: the sharded passes, gated by the
    transport when it is active."""
    if transport is not None:
        transport.check_matches_plan(plan)
        if not transport.active:
            transport = None
    return dataclasses.replace(plan, route=MeshRoute(transport))


def _check_round(state, cfg, plan: MatchingPlan, mesh) -> None:
    _check_layout(plan, mesh)
    if plan.rows != mesh.local * plan.per_rows:
        raise ValueError(f"the plan holds {plan.rows} slot rows but this process holds {mesh.local} shards of "
                         f"{plan.per_rows}: shard_matching_plan(plan, mesh)")
    if state.seen.device != mesh.device:
        raise ValueError(f"state lies on {state.seen.device} but the mesh is on {mesh.device}: shard_swarm it")
    if cfg.mode in ("push", "push_pull"):
        if plan.fanout is None or plan.deg_other is None:
            raise ValueError("sampled matching delivery needs a plan built with fanout= "
                             "(matching_powerlaw_graph_sharded(..., fanout=cfg.fanout))")
        if plan.fanout != cfg.fanout:
            raise ValueError(f"plan built for fanout={plan.fanout} but cfg.fanout={cfg.fanout}")


def gossip_round_dist_matching(state, cfg, plan: MatchingPlan, mesh, *, transport=None, collect_ici: bool = False,
                               **planes):
    """One sharded matching round: the local engine's round on the plan's
    mesh route; returns ``(new_state, RoundStats)``, with ``collect_ici``
    an :class:`~tpu_gossip_torch.dist.transport.IciRound` third.
    Bit-identical to the local round on the same plan and state under every
    plane ``run_protocol_round`` takes (``planes``: scenario, liveness,
    growth, stream, control, pipeline, the host cursors). A
    ``PackedSwarm`` runs the packed round, its exchange on the words."""
    from tpu_gossip_torch.sim.engine import gossip_round

    _check_round(state, cfg, plan, mesh)
    if transport is not None:
        transport.check_hosts(mesh)
    out = gossip_round(state, cfg, _routed(plan, transport), **planes)
    if not collect_ici:
        return out
    return (*out, _round_ici(state, cfg, plan, transport, planes.get("scenario"), mesh))


def _round_ici(state, cfg, plan, transport, scenario, mesh):
    """The counter charges the round's issued exchange: the bool round's
    effective planes, or the packed head's words with liveness=None (the
    counter's fault-free model reads transmit without the quarantine
    mask), decoded once."""
    if not is_packed(state):
        from tpu_gossip_torch.sim.stages import effective_transmit_planes

        tx_eff, transmitter, receptive = effective_transmit_planes(state, cfg, scenario)
        return _ici_matching(state, cfg, plan, transport, tx_eff, transmitter, receptive, mesh)
    from tpu_gossip_torch.sim.packed_engine import _decode_flags, packed_round_head

    m = cfg.msg_slots
    flags = _decode_flags(state)
    _, role_w, tx_w = packed_round_head(state, cfg, flags, None)
    if scenario is not None and scenario.has_blackout:
        rf = scenario.at_round(state.round + 1)
        tx_w = po.mask_rows(tx_w, ~rf.blackout)
    role_b = unpack_bits(role_w, m)
    shim = types.SimpleNamespace(seen=unpack_bits(state.seen, m), rewired=flags["rewired"])
    return _ici_matching(shim, cfg, plan, transport, unpack_bits(tx_w, m), role_b, role_b, mesh)


def _ici_matching(state, cfg, plan, transport, transmit, transmitter, receptive, mesh):
    """The analytic counter's view of one matching round: the plane masks
    the exchange is fed (fault-free single-pass model)."""
    from tpu_gossip_torch.dist.transport import ici_round_matching
    from tpu_gossip_torch.sim.engine import kernel_path_masks

    if cfg.mode == "flood":
        return ici_round_matching(plan, transport, cfg.msg_slots, transmit, None, mesh.hosts)
    tx, answer, _ = kernel_path_masks(state, cfg, transmit, transmitter, receptive)
    if cfg.mode != "push_pull":
        answer = None  # the pull direction never runs
    return ici_round_matching(plan, transport, cfg.msg_slots, tx, answer, mesh.hosts)
