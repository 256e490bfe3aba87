"""The bucketed sharded engine against the JAX package's, bit for bit:
partition tables and fingerprints, K6's shard plans, the sharded initial
state, and whole runs through the K6 receive and the scatter receive, on
a mesh of S = 1 or S = 8 shards (the JAX side on 8 virtual CPU devices)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_gossip.core.packed import pack_state as j_pack_state
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.dist import build_shard_plans as j_plans
from tpu_gossip.dist import init_sharded_swarm as j_init
from tpu_gossip.dist import make_mesh as j_mesh
from tpu_gossip.dist import partition_graph as j_partition
from tpu_gossip.dist import run_until_coverage_dist as j_run
from tpu_gossip.dist import shard_swarm as j_shard
from tpu_gossip.dist import simulate_dist as j_sim
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip_torch import convert
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state as t_pack_state
from tpu_gossip_torch.core.packed import unpack_state as t_unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_staircase import chung_lu

N = 2000


@pytest.fixture(scope="module")
def graph():
    return chung_lu(N, seed=3)


def _partitions(g, s, window=1024, seed=1):
    return (j_partition(g, s, seed=seed, window=window),
            tdist.partition_graph(g, s, seed=seed, window=window, device="cpu"))


@pytest.mark.parametrize("s,window", [(1, 1024), (2, 1024), (8, 1024), (8, 1)])
def test_partition_tables_equal_jax(graph, s, window):
    (jsg, jrel, jpos), (tsg, trel, tpos) = _partitions(graph, s, window)
    for name in convert.SHARDED_LEAVES:
        np.testing.assert_array_equal(getattr(tsg, name).numpy(), np.asarray(getattr(jsg, name)), err_msg=name)
    for name in convert.SHARDED_STATIC:
        assert getattr(tsg, name) == getattr(jsg, name), name
    assert tsg.fingerprint != 0
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(trel.row_ptr, jrel.row_ptr)
    np.testing.assert_array_equal(trel.col_idx, jrel.col_idx)


@pytest.mark.parametrize("s", [1, 2, 8])
def test_shard_plans_equal_jax(graph, s):
    (jsg, _, _), (tsg, _, _) = _partitions(graph, s)
    jp, tp = j_plans(jsg), tdist.build_shard_plans(tsg)
    for name in convert.SHARD_PLAN_LEAVES:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    for name in convert.SHARD_PLAN_STATIC:
        assert getattr(tp, name) == getattr(jp, name), name
    tp.check_matches(tsg)
    # the converted JAX plan is the port's own
    cp = convert.shard_plans_from_jax({k: np.asarray(getattr(jp, k)) for k in convert.SHARD_PLAN_LEAVES},
                                      {k: getattr(jp, k) for k in convert.SHARD_PLAN_STATIC}, device="cpu")
    assert all(torch.equal(getattr(cp, k), getattr(tp, k)) for k in convert.SHARD_PLAN_LEAVES)


def test_shard_plans_refuse_another_partition_and_unaligned_buckets(graph):
    (_, _, _), (tsg, _, _) = _partitions(graph, 2)
    _, (other, _, _) = _partitions(graph, 2, seed=2)
    plan = tdist.build_shard_plans(tsg)
    with pytest.raises(ValueError, match="fingerprint"):
        plan.check_matches(other)
    _, (scatter_only, _, _) = _partitions(graph, 2, window=1)
    with pytest.raises(ValueError, match="window-aligned"):
        tdist.build_shard_plans(scatter_only)


def _build(g, s, seed=1, origins=(0, 5), exists=None, m=16, **cfg_kw):
    """The same sharded swarm in both packages: ((cfg, state, sg, mesh), (...))."""
    (jsg, jrel, jpos), (tsg, trel, tpos) = _partitions(g, s, seed=seed)
    kw = dict(n_peers=tsg.n_pad, msg_slots=m, **cfg_kw)
    jm, tm = j_mesh(s), tdist.make_mesh(s, device="cpu")
    js = j_init(jsg, jrel, jpos, JConfig(**kw), key=jax.random.key(seed), origins=list(origins), exists=exists)
    ts = tdist.init_sharded_swarm(tsg, trel, tpos, TConfig(**kw), key=prng.key(seed, "cpu"), origins=list(origins),
                                  exists=exists, device="cpu")
    return (JConfig(**kw), j_shard(js, jm), jsg, jm), (TConfig(**kw), tdist.shard_swarm(ts, tm), tsg, tm)


def test_init_sharded_swarm_digest_equals_jax(graph):
    exists = np.random.default_rng(0).random(N) < 0.9
    exists[[0, 5]] = True
    (_, js, _, _), (_, ts, _, _) = _build(graph, 8, exists=exists, mode="push_pull", fanout=1)
    assert t_state_digest(ts) == j_state_digest(js)
    assert int(ts.exists.sum()) == int(exists.sum())  # pad slots and absent ids born dead


RUNS = {  # name: (shards, K6 receive, config)
    "push_pull_f1_k6_s8": (8, True, dict(mode="push_pull", fanout=1)),
    "push_pull_f1_scatter_s8": (8, False, dict(mode="push_pull", fanout=1)),
    "flood_k6_s8": (8, True, dict(mode="flood")),
    "flood_scatter_s1": (1, False, dict(mode="flood")),
    "push_f2_k6_s1": (1, True, dict(mode="push", fanout=2)),
    "push_pull_forward_once_k6_s1": (1, True, dict(mode="push_pull", fanout=1, forward_once=True)),
    "push_pull_sir4_k6_s1": (1, True, dict(mode="push_pull", fanout=1, sir_recover_rounds=4)),
    "push_pull_m40_k6_s1": (1, True, dict(mode="push_pull", fanout=1, m=40)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_simulate_dist_digests_equal_jax(graph, name):
    s, k6, cfg_kw = RUNS[name]
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, s, origins=(0, 5, 77), **cfg_kw)
    m = tc.msg_slots
    if m > 32:
        # one rumor in every slot, so the second word group carries traffic
        js = dataclasses.replace(js, seen=js.seen.at[np.arange(m), np.arange(m)].set(True))
        ts.seen[np.arange(m), np.arange(m)] = True
    jp = j_plans(jsg) if k6 else None
    tp = tdist.build_shard_plans(tsg) if k6 else None
    jf, jst = j_sim(js, jc, jsg, jm, 8, jp)
    tf, tst = tdist.simulate_dist(ts, tc, tsg, tm, 8, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    np.testing.assert_array_equal(tst.coverage.numpy(), np.asarray(jst.coverage))
    assert int(tst.msgs_sent.sum()) > 0
    if m > 32:
        assert bool(tf.seen[:, 32:].any())


@pytest.mark.parametrize("s", [1, 8])
def test_packed_simulate_dist_equals_jax_and_unpacked(graph, s):
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, s, mode="push_pull", fanout=1)
    jp, tp = j_plans(jsg), tdist.build_shard_plans(tsg)
    tf_u, tst_u = tdist.simulate_dist(ts, tc, tsg, tm, 8, tp)
    jf, jst = j_sim(j_pack_state(js), jc, jsg, jm, 8, jp)
    tf, tst = tdist.simulate_dist(t_pack_state(ts), tc, tsg, tm, 8, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst) == t_stats_digest(tst_u)
    assert t_state_digest(t_unpack_state(tf)) == t_state_digest(tf_u)


@pytest.mark.parametrize("k6", [False, True])
def test_run_until_coverage_dist_rounds_equal_jax(graph, k6):
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, 8, mode="push_pull", fanout=1)
    jf = j_run(js, jc, jsg, jm, 0.99, 200, shard_plan=j_plans(jsg) if k6 else None)
    tf = tdist.run_until_coverage_dist(ts, tc, tsg, tm, 0.99, 200, shard_plan=tdist.build_shard_plans(tsg) if k6
                                       else None)
    assert int(tf.round) == int(jf.round) > 0
    assert t_state_digest(tf) == j_state_digest(jf)


def test_converted_jax_partition_runs_like_the_port(graph):
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, 2, mode="push", fanout=2)
    csg = convert.sharded_graph_from_jax({k: np.asarray(getattr(jsg, k)) for k in convert.SHARDED_LEAVES},
                                         {k: getattr(jsg, k) for k in convert.SHARDED_STATIC}, device="cpu")
    a, _ = tdist.simulate_dist(ts, tc, csg, tm, 4)
    b, _ = tdist.simulate_dist(ts, tc, tsg, tm, 4)
    assert t_state_digest(a) == t_state_digest(b)


REFUSED = ["matching_plan", "transport", "collect_ici", "rewire_slots", "scenario", "packed_stream", "stream",
           "control", "pipeline", "liveness", "inject"]


def _ported_since(graph, what) -> None:
    """The arguments ROADMAP item 11b ported: a sharded MatchingPlan on the
    mesh runs the sharded matching engine (its round equals the local
    round on the same plan, pipelined too), ``transport`` moves the
    bucketed exchange through its compact lane (the round equals the dense
    one), and ``collect_ici`` returns the round's counters, equal to the
    JAX package's ``ici_round_bucketed`` on the same planes."""
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.sim.engine import simulate
    from tpu_gossip_torch.sim.stages import compile_pipeline

    if what in ("matching_plan", "pipeline"):
        from tpu_gossip_torch.core.state import init_swarm

        g, plan = matching_powerlaw_graph_sharded(600, 2, fanout=1, key=prng.key(0, "cpu"), device="cpu")
        cfg = TConfig(n_peers=plan.n, msg_slots=4, fanout=1, mode="push_pull")
        st = init_swarm(g.as_padded_graph(), cfg, origins=[0], exists=g.exists, key=prng.key(1, "cpu"),
                        device="cpu")
        mesh = tdist.make_mesh(2, device="cpu")
        kw = {"pipeline": compile_pipeline(1)} if what == "pipeline" else {}
        a, sa = tdist.simulate_dist(st, cfg, tdist.shard_matching_plan(plan, mesh), mesh, 4, **kw)
        b, sb = simulate(st, cfg, 4, plan, **kw)
        assert (t_state_digest(a), t_stats_digest(sa)) == (t_state_digest(b), t_stats_digest(sb))
        return
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, 2, mode="push_pull", fanout=1)
    if what == "transport":
        a, sa = tdist.simulate_dist(ts, tc, tsg, tm, 4, transport=tdist.build_transport(tsg, "sparse"))
        b, sb = tdist.simulate_dist(ts, tc, tsg, tm, 4)
        assert (t_state_digest(a), t_stats_digest(sa)) == (t_state_digest(b), t_stats_digest(sb))
        return
    import jax.numpy as jnp

    from tpu_gossip.dist.transport import ici_round_bucketed

    _, _, ici = tdist.gossip_round_dist(ts, tc, tsg, tm, collect_ici=True)
    active = np.asarray(js.alive) & ~np.asarray(js.declared_dead)
    tx_any = (np.asarray(js.seen) & active[:, None] & ~np.asarray(js.recovered)).any(-1)
    want = ici_round_bucketed(jsg, None, 2, jnp.asarray(tx_any), None, True)
    assert {f: int(getattr(ici, f)) for f in ici._fields} == {f: int(np.asarray(getattr(want, f)))
                                                               for f in want._fields}


@pytest.mark.parametrize("what", REFUSED)
def test_refused_arguments_raise_not_ported(graph, what):
    """The arguments of later slices raise ``NotImplementedError``; those
    ported since (:func:`_ported_since`) run as their slice says."""
    if what in ("matching_plan", "transport", "collect_ici", "pipeline"):
        _ported_since(graph, what)
        return
    _, (tc, ts, tsg, tm) = _build(graph, 2, mode="push_pull", fanout=1)
    sg, kw = tsg, {}
    if what == "matching_plan":
        from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph

        _, sg = matching_powerlaw_graph(200, fanout=1, key=prng.key(0, "cpu"), device="cpu")
    elif what in ("packed_stream", "stream"):
        # streams run on this engine, packed or not; composed with a later
        # slice's argument (pipelining, live ingestion) they are refused
        from tpu_gossip_torch.core.packed import pack_state
        from tpu_gossip_torch.traffic import compile_stream

        kw["stream"] = compile_stream(rate=2.0, msg_slots=16, ttl=20, origin_rows=np.arange(N), device="cpu")
        if what == "packed_stream":
            ts = pack_state(ts)
        kw["inject"] = object()
    elif what == "control":
        # the controller runs on this engine; composed with live ingestion
        # it is refused
        from tpu_gossip_torch.control import compile_control

        kw["control"] = compile_control(target_ratio=0.9, fanout=1, device="cpu")
        kw["inject"] = object()
    elif what == "pipeline":
        # pipelined rounds run on this engine (test_torch_pipeline.py); on
        # the matching mesh, a later slice, they are refused with it
        from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
        from tpu_gossip_torch.sim.stages import compile_pipeline

        _, sg = matching_powerlaw_graph(200, fanout=1, key=prng.key(0, "cpu"), device="cpu")
        kw["pipeline"] = compile_pipeline(1)
    elif what in ("rewire_slots", "scenario", "liveness"):
        # re-wiring, scenarios (admission waves included), the quorum
        # detector and growth run on this engine, churn bursts included;
        # each case adds a live-ingestion batch, the serving slice's
        from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
        from tpu_gossip_torch.kernels.liveness import compile_quorum

        if what == "rewire_slots":
            _, (tc, ts, tsg, tm) = _build(graph, 2, mode="push_pull", fanout=1, rewire_slots=2, churn_join_prob=0.1)
        kw["scenario"] = compile_scenario(
            scenario_from_dict({"phases": [{"start": 0, "end": 4, "churn_join": 0.2, "join_burst": 2}]}),
            n_peers=N, n_slots=tsg.n_pad, total_rounds=8, device="cpu")
        if what == "liveness":
            kw["liveness"] = compile_quorum(3)
        kw["inject"] = object()
    else:
        kw[what] = True if what == "collect_ici" else object()
    with pytest.raises(NotImplementedError, match="not ported"):
        tdist.gossip_round_dist(ts, tc, sg, tm, **kw)


def test_mesh_and_partition_must_agree(graph):
    _, (tc, ts, tsg, _) = _build(graph, 2, mode="flood")
    with pytest.raises(ValueError, match="partitioned for 2 shards"):
        tdist.gossip_round_dist(ts, tc, tsg, tdist.make_mesh(1, device="cpu"))


def test_make_mesh_on_several_cards_is_a_later_slice(monkeypatch):
    """One process on a host of several cards holds one shard on its card
    (the several-card mesh is one process a card, ``cluster.launch``, ROADMAP
    item 11c); more shards stack on the card only when asked for, by size
    or by ``TPU_GOSSIP_TORCH_LOCAL_SHARDS`` (the launcher's
    ``--devices-per-host``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = tdist.make_mesh()
    assert (mesh.size, mesh.hosts, mesh.world, mesh.rank, mesh.local, str(mesh.device)) == (1, 1, 1, 0, 1, "cuda:0")
    assert tdist.make_mesh(3).size == 3  # shards stacked on one card only when asked for
    assert tdist.make_mesh(device="cpu").size == 1
    monkeypatch.setenv("TPU_GOSSIP_TORCH_LOCAL_SHARDS", "4")
    assert tdist.make_mesh(device="cpu").size == 4
