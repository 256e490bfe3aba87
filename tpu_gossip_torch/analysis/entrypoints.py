"""The shared entry matrix: the port's public round entry points, under the
JAX package's names (``tpu_gossip/analysis/entrypoints.py``), at its shapes.

The matrix is the product the bit-identity contract quantifies over: the
three local delivery engines (``xla``: exactly-k over the CSR; ``pallas``:
the staircase plan, K5; ``matching``: the matching plan, K1 and K2) ×
modes × message slots, churn, SIR and the compact side paths, every tail
(K3, K4), scenarios, growth, streams, serving batches, control and the
quorum detector's adversaries, their compositions, the loops and their
packed twins, the fleet, and both one-process mesh engines (the sharded
matching engine and the bucketed engine with K6's receive) dense, sparse,
pipelined, packed and folded into (hosts, devices) with the hier
transport. The contract audit runs each entry once; the memory tier runs
each under the op recorder (``optrace.py``).

Each :class:`EntryPoint` builds its inputs from seed 0 on the device it is
given and resolves its callable through the owning module at call time
(``engine.gossip_round``), so a test can patch a deliberate break in.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Tuple

__all__ = ["EntryPoint", "RanEntry", "entry_points", "run_matrix", "N_SHARDS"]

_N_MATCH = 256  # tiny matching build
_N_DEV = 512  # tiny device-CSR build
_MSG_SLOTS = (1, 16)
_MODES = ("push", "push_pull", "flood")
_SIM_ROUNDS = 3
_DIST_SIM_ROUNDS = 2
_FLEET_LANES = 3
_FLEET_PEERS = 64
_FLEET_ROUNDS = 2
N_SHARDS = 8  # the one-process mesh (JAX's forced 8 host devices)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One public entry point of the round machinery.

    ``build(device)`` returns ``(fn, state)``: ``fn(state)`` runs the entry
    with every other operand closed over. ``stats_leading`` is the stats'
    leading shape (None: the entry returns a state only); ``has_ici``: the
    output carries an ``IciRound`` third."""

    name: str
    engine: str  # xla | pallas | matching | dist-matching | dist-bucketed
    kind: str  # round | simulate | coverage
    audit_check: str
    build: Callable[[Any], Tuple[Callable, Any]]
    stats_leading: tuple | None = ()
    has_ici: bool = False
    packed: bool = False


@dataclasses.dataclass
class RanEntry:
    """One entry's run: its input state, its output, or the error."""

    ep: EntryPoint
    state: Any = None
    out: Any = None
    error: str | None = None
    seconds: float = 0.0
    peak_bytes: int | None = None  # device peak of the run (CUDA only)
    record: Any = None  # optrace.OpRecord of the run (the memory tier)


def _key(device):
    from tpu_gossip_torch.core import prng

    return prng.key(0, device)


@functools.lru_cache(maxsize=None)
def _ctx(device: str):
    """Tiny graphs, plans and a state factory shared by the local entries."""
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan

    dg = device_powerlaw_graph(_N_DEV, gamma=2.5, key=_key(device), device=device)
    mg, mplan = matching_powerlaw_graph(_N_MATCH, gamma=2.5, fanout=1, key=_key(device), export_csr=True,
                                        device=device)
    splan = build_staircase_plan(dg.row_ptr.cpu().numpy(), dg.col_idx.cpu().numpy(), fanout=1, device=device)

    def state_for(graph, m: int, **cfg_kw):
        cfg = SwarmConfig(n_peers=graph.n_pad, msg_slots=m, fanout=1, **cfg_kw)
        st = init_swarm(graph.as_padded_graph(), cfg, origins=[0], exists=graph.exists, key=_key(device),
                        device=device)
        return st, cfg

    return {"dg": dg, "mg": mg, "mplan": mplan, "splan": splan, "state_for": state_for}


def _chaos_scenario(n_slots: int, n_real: int, device):
    """Every fault class active: loss, delay, partition, blackout, churn burst."""
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict

    spec = scenario_from_dict({
        "name": "audit-chaos",
        "phases": [
            {"name": "lossy", "start": 0, "end": 2, "loss": 0.2, "delay": 0.2},
            {"name": "split", "start": 2, "end": 4, "partition": "half"},
            {"name": "storm", "start": 4, "end": 6, "churn_leave": 0.05, "churn_join": 0.2,
             "blackout": {"frac": 0.1, "seed": 1}},
        ],
    })
    return compile_scenario(spec, n_peers=n_real, n_slots=n_slots, total_rounds=8, device=device)


def _adversary_scenario(n_slots: int, n_real: int, device):
    """Accusers, forgers and floods beside a blackout."""
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict

    spec = scenario_from_dict({
        "name": "audit-byzantine",
        "phases": [
            {"name": "dark", "start": 0, "end": 2, "blackout": {"frac": 0.1, "seed": 2}},
            {"name": "siege", "start": 2, "end": 6, "accusers": {"frac": 0.05, "seed": 3},
             "forgers": {"frac": 0.02, "seed": 4}, "floods": {"frac": 0.03, "seed": 5},
             "forge_fanout": 2, "flood_fanout": 3},
        ],
    })
    return compile_scenario(spec, n_peers=n_real, n_slots=n_slots, total_rounds=8, device=device)


def _quorum_spec():
    from tpu_gossip_torch.kernels.liveness import compile_quorum

    return compile_quorum(quorum_k=3, window=4, budget=2)


def _growth_plan(n_slots: int, n_initial: int, device):
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.growth import compile_growth

    prng.gumbel_table(device)  # the draw's table, built once a device: set-up, not the round's
    target = min(n_initial + 32, n_slots)
    return compile_growth(n_initial=n_initial, target=target, n_slots=n_slots, joins_per_round=4, attach_m=2,
                          admit_rows=np.arange(n_initial, target), max_join_burst=4, device=device)


def _stream_plan(msg_slots: int, exists, device, *, k_hashes: int = 2):
    import numpy as np

    from tpu_gossip_torch.traffic import compile_stream

    return compile_stream(rate=2.0, msg_slots=msg_slots, ttl=8, origin_rows=np.flatnonzero(exists.cpu().numpy()),
                          k_hashes=min(k_hashes, msg_slots), burst_every=4, device=device)


def _ingest_batch(msg_slots: int, device, *, max_inject: int = 4):
    from tpu_gossip_torch.serve.protocol import payload_hash64
    from tpu_gossip_torch.traffic.ingest import IngestPlan, make_batch

    plan = IngestPlan(msg_slots=msg_slots, max_inject=max_inject, k_hashes=1)
    hashes = [payload_hash64(f"2025-01-01 00:00:0{i}:10.0.0.{i}:6000:{i}") for i in range(3)]
    return make_batch(plan, [1, 2, 3], hashes, overflow=2, device=device)


def _control_plan(device, ttl: int = 0):
    from tpu_gossip_torch.control import compile_control

    return compile_control(target_ratio=0.9, fanout=1, lo=1, hi=3, refresh_every=2, ttl=ttl, device=device)


@functools.lru_cache(maxsize=None)
def _dist_ctx(device: str):
    """The one-process mesh, its sharded graphs and the state factories."""
    import numpy as np

    from tpu_gossip_torch.cluster.topology import make_cluster_mesh
    from tpu_gossip_torch.core import matching_topology as mt
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.core.topology import build_csr, configuration_model, powerlaw_degree_sequence
    from tpu_gossip_torch.dist import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(N_SHARDS, device)
    g, plan = mt.matching_powerlaw_graph_sharded(_N_MATCH, mesh.size, gamma=2.5, fanout=1, key=_key(device),
                                                 export_csr=False, device=device)

    def m_state(**cfg_kw):
        cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull", **cfg_kw)
        st = init_swarm(g.as_padded_graph(), cfg, origins=[0], exists=g.exists, key=_key(device), device=device)
        return st, cfg

    rng = np.random.default_rng(0)
    graph = build_csr(_N_DEV, configuration_model(powerlaw_degree_sequence(_N_DEV, gamma=2.5, rng=rng), rng=rng))
    sg, relabeled, position = mesh_mod.partition_graph(graph, mesh.size, seed=0, device=device)
    shard_plan = mesh_mod.build_shard_plans(sg)

    def b_state(**cfg_kw):
        cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=16, fanout=1, mode="push_pull", **cfg_kw)
        st = mesh_mod.init_sharded_swarm(sg, relabeled, position, cfg, origins=[0], key=_key(device),
                                         device=device)
        return st, cfg

    # the (hosts, devices) fold of the same shards, row-major
    mesh2 = make_cluster_mesh(mesh.size, hosts=2, device=device)
    return {"mesh": mesh, "mesh2": mesh2, "g": g, "plan": plan, "sg": sg, "shard_plan": shard_plan,
            "m_state": m_state, "b_state": b_state}


def _local_entries() -> list[EntryPoint]:
    from tpu_gossip_torch.sim import engine  # resolved through the module at call time

    eps: list[EntryPoint] = []

    def engines(ctx):
        return {"xla": (ctx["dg"], None), "pallas": (ctx["dg"], ctx["splan"]),
                "matching": (ctx["mg"], ctx["mplan"])}

    def add(name, eng, build, **kw):
        eps.append(EntryPoint(name=name, engine=eng, kind=kw.pop("kind", "round"),
                              audit_check=kw.pop("audit_check", "gossip_round_local"), build=build, **kw))

    def round_ep(name, eng, m, cfg_kw, round_kw, plans=None):
        """A gossip_round entry; ``plans(ctx, graph, device)`` adds the
        round's compiled planes."""

        def build(device):
            ctx = _ctx(str(device))
            graph, plan = engines(ctx)[eng]
            st, cfg = ctx["state_for"](graph, m, **cfg_kw)
            kw = dict(round_kw)
            if plans is not None:
                kw.update(plans(ctx, graph, st, device))
            return (lambda s: engine.gossip_round(s, cfg, plan, **kw)), st

        add(name, eng, build)

    for m in _MSG_SLOTS:
        for mode in _MODES:
            for eng in ("xla", "pallas", "matching"):
                round_ep(f"local[{eng},{mode},m={m}]", eng, m, dict(mode=mode), {})
    churn = dict(churn_leave_prob=0.002, churn_join_prob=0.02, rewire_slots=2)
    round_ep("local[xla,churn]", "xla", 16, dict(mode="push_pull", **churn), {})
    round_ep("local[xla,sir]", "xla", 16, dict(mode="push_pull", sir_recover_rounds=8), {})
    round_ep("local[xla,churn-compact]", "xla", 16, dict(mode="push_pull", rewire_compact_cap=64, **churn), {})
    for tail in ("reference", "fused", "pallas", "packed", "packed_pallas"):
        round_ep(f"local[xla,tail={tail}]", "xla", 16, dict(mode="push_pull", sir_recover_rounds=4, **churn),
                 dict(tail=tail))
    full = dict(mode="push_pull", rewire_slots=2, churn_join_prob=0.02, churn_leave_prob=0.002)
    for eng in ("xla", "matching"):
        round_ep(f"local[{eng},scenario]", eng, 16, full, {},
                 lambda ctx, g, st, d, eng=eng: {"scenario": _chaos_scenario(g.n_pad, g.n, d)})
    for eng in ("xla", "pallas", "matching"):
        round_ep(f"local[{eng},growth]", eng, 16, dict(mode="push_pull", rewire_slots=2), {},
                 lambda ctx, g, st, d: {"growth": _growth_plan(g.n_pad, g.n_pad - 40, d)})
    for eng in ("xla", "pallas", "matching"):
        round_ep(f"local[{eng},stream]", eng, 16, dict(mode="push_pull"), {},
                 lambda ctx, g, st, d: {"stream": _stream_plan(16, g.exists, d)})
    for eng in ("xla", "pallas", "matching"):
        round_ep(f"local[{eng},ingest]", eng, 16, dict(mode="push_pull"), {},
                 lambda ctx, g, st, d: {"stream": _stream_plan(16, g.exists, d), "inject": _ingest_batch(16, d)})

    def composed(*planes):
        def plans(ctx, g, st, d):
            kw = {}
            if "adversary" in planes:
                kw["scenario"], kw["liveness"] = _adversary_scenario(g.n_pad, _N_DEV, d), _quorum_spec()
            elif "scenario" in planes:
                kw["scenario"] = _chaos_scenario(g.n_pad, _N_DEV, d)
            if "growth" in planes:
                kw["growth"] = _growth_plan(g.n_pad, g.n_pad - 40, d)
            if "stream" in planes:
                kw["stream"] = _stream_plan(16, g.exists, d)
            if "control" in planes:
                kw["control"] = _control_plan(d, ttl=8)
            return kw

        return plans

    round_ep("local[xla,scenario+growth]", "xla", 16, full, {}, composed("scenario", "growth"))
    round_ep("local[xla,scenario+growth+stream]", "xla", 16, full, {}, composed("scenario", "growth", "stream"))
    for eng in ("xla", "pallas", "matching"):
        round_ep(f"local[{eng},control]", eng, 16, full, {}, lambda ctx, g, st, d: {"control": _control_plan(d)})
    round_ep("local[xla,scenario+growth+stream+control]", "xla", 16, full, {},
             composed("scenario", "growth", "stream", "control"))
    round_ep("local[xla,adversary]", "xla", 16, full, {}, composed("adversary"))
    round_ep("local[xla,scenario+growth+stream+control+adversary]", "xla", 16, full, {},
             composed("adversary", "growth", "stream", "control"))

    def loop_ep(name, kind, packed):
        def build(device):
            from tpu_gossip_torch.core.packed import pack_state

            ctx = _ctx(str(device))
            st, cfg = ctx["state_for"](ctx["dg"], 16, mode="push_pull")
            if kind == "simulate":
                fn = lambda s: engine.simulate(s, cfg, _SIM_ROUNDS)  # noqa: E731
            else:
                fn = lambda s: engine.run_until_coverage(s, cfg, 0.99, 10)  # noqa: E731
            return fn, pack_state(st) if packed else st

        add(name, "xla", build, kind=kind, audit_check="simulate_and_coverage", packed=packed,
            stats_leading=(_SIM_ROUNDS,) if kind == "simulate" else None)

    loop_ep("local[simulate]", "simulate", False)
    loop_ep("local[run_until_coverage]", "coverage", False)
    loop_ep("local[simulate,packed]", "simulate", True)
    loop_ep("local[run_until_coverage,packed]", "coverage", True)

    def build_round_packed(device):
        from tpu_gossip_torch.core.packed import pack_state

        ctx = _ctx(str(device))
        st, cfg = ctx["state_for"](ctx["dg"], 16, mode="push_pull", sir_recover_rounds=4, forward_once=True)
        return (lambda s: engine.gossip_round(s, cfg, None)), pack_state(st)

    add("local[xla,round,packed-native]", "xla", build_round_packed, packed=True)

    def build_fleet(device):
        from tpu_gossip_torch.fleet import engine as fleet_eng
        from tpu_gossip_torch.fleet import plan as fleet_plan

        spec = fleet_plan.campaign_from_dict({
            "name": "audit-fleet", "seed": 0,
            "base": {"peers": _FLEET_PEERS, "rounds": _FLEET_ROUNDS, "slots": 16, "fanout": 1, "mode": "push_pull",
                     "stream_rate": 1.0, "slot_ttl": 12, "control": 0.9, "control_hi": 3, "rewire_slots": 3,
                     "churn_join": 0.02},
            "families": [{
                "name": "chaos",
                "scenario": {"name": "audit-fleet-chaos", "phases": [
                    {"name": "lossy", "start": 0, "end": 1, "loss": 0.2, "delay": 0.2},
                    {"name": "split", "start": 1, "end": 2, "partition": "half",
                     "blackout": {"frac": 0.1, "seed": 1}},
                ]},
                "seeds": _FLEET_LANES,
                "sweeps": [{"axis": "phase.loss", "dist": "uniform", "lo": 0.1, "hi": 0.4}],
            }],
        })
        camp = fleet_plan.compile_campaign(spec, device=device)
        return (lambda s: fleet_eng.simulate_fleet(s, camp.cfg, camp.rounds, camp.scenario, camp.growth,
                                                   camp.stream, camp.control)), camp.states

    add("fleet[simulate,composed]", "xla", build_fleet, kind="simulate", audit_check="simulate_and_coverage",
        stats_leading=(_FLEET_LANES, _FLEET_ROUNDS))
    return eps


def _dist_entries() -> list[EntryPoint]:
    from tpu_gossip_torch.dist import mesh as mesh_mod  # resolved at call time

    eps: list[EntryPoint] = []

    def dist_ep(name, eng, audit_check, state_kw, round_kw, *, kind="round", stats_leading=(), has_ici=False,
                mesh2=False, packed=False):
        def build(device):
            from tpu_gossip_torch.core.packed import pack_state

            dctx = _dist_ctx(str(device))
            matching = eng == "dist-matching"
            st, cfg = (dctx["m_state"] if matching else dctx["b_state"])(**state_kw)
            target = dctx["plan"] if matching else dctx["sg"]
            mesh = dctx["mesh2"] if mesh2 else dctx["mesh"]
            n_slots, n_real = (dctx["plan"].n, _N_MATCH) if matching else (dctx["sg"].n_pad, _N_DEV)
            kw = dict(round_kw)
            if kw.pop("scenario", False):
                kw["scenario"] = _chaos_scenario(n_slots, n_real, device)
            if kw.pop("adversary", False):
                kw["scenario"], kw["liveness"] = _adversary_scenario(n_slots, n_real, device), _quorum_spec()
            if kw.pop("growth", False):
                kw["growth"] = _growth_plan(n_slots, n_slots - 40, device)
            if kw.pop("sparse", False):
                from tpu_gossip_torch.dist import transport as tp

                kw["transport"] = tp.build_transport(target, mode="sparse")
            if kw.pop("hier", False):
                from tpu_gossip_torch.cluster.topology import mesh_hosts
                from tpu_gossip_torch.dist import transport as tp

                kw["transport"] = tp.build_transport(target, mode="hier", hosts=mesh_hosts(mesh)[0])
            if kw.pop("stream", False):
                kw["stream"] = _stream_plan(16, st.exists, device)
            if kw.pop("ingest", False):
                kw["stream"], kw["inject"] = _stream_plan(16, st.exists, device), _ingest_batch(16, device)
            if kw.pop("control", False):
                kw["control"] = _control_plan(device)
            if kw.pop("pipeline", False):
                from tpu_gossip_torch.sim.stages import compile_pipeline

                kw["pipeline"] = compile_pipeline(1)
            shard_plan = None if matching else dctx["shard_plan"]
            if kind == "round":
                fn = lambda s: mesh_mod.gossip_round_dist(s, cfg, target, mesh, shard_plan, **kw)  # noqa: E731
            elif kind == "simulate":
                fn = lambda s: mesh_mod.simulate_dist(s, cfg, target, mesh, _DIST_SIM_ROUNDS,  # noqa: E731
                                                      shard_plan, **kw)
            else:
                fn = lambda s: mesh_mod.run_until_coverage_dist(s, cfg, target, mesh, 0.99, 6,  # noqa: E731
                                                                shard_plan=shard_plan, **kw)
            return fn, pack_state(st) if packed else st

        eps.append(EntryPoint(name=name, engine=eng, kind=kind, audit_check=audit_check, build=build,
                              stats_leading=stats_leading, has_ici=has_ici, packed=packed))

    dist_ep("dist[matching]", "dist-matching", "gossip_round_dist", {}, {})
    dist_ep("dist[matching,scenario]", "dist-matching", "gossip_round_dist", {}, dict(scenario=True))
    dist_ep("dist[matching,growth]", "dist-matching", "gossip_round_dist", dict(rewire_slots=2), dict(growth=True))
    dist_ep("dist[matching,stream]", "dist-matching", "gossip_round_dist", {}, dict(stream=True))
    dist_ep("dist[matching,ingest]", "dist-matching", "gossip_round_dist", {}, dict(ingest=True))
    dist_ep("dist[matching,adversary+scenario]", "dist-matching", "gossip_round_dist", {}, dict(adversary=True))
    dist_ep("dist[bucketed]", "dist-bucketed", "gossip_round_dist", {}, {})
    dist_ep("dist[bucketed,growth]", "dist-bucketed", "gossip_round_dist", dict(rewire_slots=2), dict(growth=True))
    dist_ep("dist[bucketed,stream]", "dist-bucketed", "gossip_round_dist", {}, dict(stream=True))
    dist_ep("dist[matching,control]", "dist-matching", "gossip_round_dist", {}, dict(control=True))
    dist_ep("dist[bucketed,control]", "dist-bucketed", "gossip_round_dist",
            dict(rewire_slots=2, churn_join_prob=0.02, churn_leave_prob=0.002), dict(control=True))
    dist_ep("dist[matching,pipeline]", "dist-matching", "gossip_round_dist", {}, dict(pipeline=True))
    dist_ep("dist[bucketed,pipeline]", "dist-bucketed", "gossip_round_dist", {}, dict(pipeline=True))
    dist_ep("dist[matching,pipeline+scenario+stream]", "dist-matching", "gossip_round_dist", {},
            dict(pipeline=True, scenario=True, stream=True))
    dist_ep("dist[matching,simulate]", "dist-matching", "gossip_round_dist", {}, {}, kind="simulate",
            stats_leading=(_DIST_SIM_ROUNDS,))
    dist_ep("dist[matching,simulate,packed]", "dist-matching", "gossip_round_dist", {}, {}, kind="simulate",
            stats_leading=(_DIST_SIM_ROUNDS,), packed=True)
    dist_ep("dist[matching,round,packed-native]", "dist-matching", "gossip_round_dist", {}, {}, packed=True)
    dist_ep("dist[bucketed,round,packed-native]", "dist-bucketed", "gossip_round_dist", {}, {}, packed=True)
    dist_ep("dist[bucketed,run_until_coverage]", "dist-bucketed", "gossip_round_dist", {}, {}, kind="coverage",
            stats_leading=None)
    dist_ep("dist[matching,sparse]", "dist-matching", "sparse_transport", {}, dict(sparse=True, collect_ici=True),
            has_ici=True)
    dist_ep("dist[bucketed,sparse]", "dist-bucketed", "sparse_transport", {}, dict(sparse=True, collect_ici=True),
            has_ici=True)
    dist_ep("dist[matching,2d]", "dist-matching", "gossip_round_dist", {}, {}, mesh2=True)
    dist_ep("dist[bucketed,2d]", "dist-bucketed", "gossip_round_dist", {}, {}, mesh2=True)
    dist_ep("dist[matching,hier]", "dist-matching", "sparse_transport", {}, dict(hier=True, collect_ici=True),
            has_ici=True, mesh2=True)
    dist_ep("dist[bucketed,hier]", "dist-bucketed", "sparse_transport", {}, dict(hier=True, collect_ici=True),
            has_ici=True, mesh2=True)
    return eps


def entry_points() -> tuple[EntryPoint, ...]:
    """The whole matrix: the local entries, then the one-process mesh's."""
    return tuple(_local_entries() + _dist_entries())


def run_matrix(eps, device, cache: Dict[str, RanEntry] | None = None, record: bool = False) -> Dict[str, RanEntry]:
    """Run every entry of ``eps`` once on ``device``; name -> :class:`RanEntry`.

    A failed build or run records its error instead of raising (the
    consumer turns it into a finding). ``record`` runs each entry under
    the op recorder (``optrace.py``, CPU only). On a CUDA device each run's
    ``torch.cuda.max_memory_allocated`` above the bytes already allocated
    is its ``peak_bytes``. ``cache`` shares runs between the passes of one
    invocation."""
    import torch

    device = torch.device(device)
    out: Dict[str, RanEntry] = {}
    for ep in eps:
        hit = None if cache is None else cache.get(ep.name)
        if hit is not None and (hit.record is not None or not record or hit.error is not None):
            out[ep.name] = hit
            continue
        ran = RanEntry(ep=ep)
        try:
            fn, st = ep.build(device)
            ran.state = st
            base = 0
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            if record:
                from tpu_gossip_torch.analysis.optrace import record_ops

                with record_ops(st) as rec:
                    ran.out = fn(st)
                ran.record = rec
            else:
                ran.out = fn(st)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                ran.peak_bytes = int(torch.cuda.max_memory_allocated(device) - base)
            ran.seconds = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 (the consumers report, not crash)
            ran.error = f"{e!r:.300}"
        out[ep.name] = ran
        if cache is not None:
            cache[ep.name] = ran
    return out
