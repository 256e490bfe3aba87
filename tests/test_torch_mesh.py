"""The sharded matching engine (ROADMAP item 11b) against the JAX package
on the CPU, without a JAX mesh: the sharded transposes against JAX's
global ``transpose_pass`` on seeded planes, the sparse transposes with
hub rows against the dense ones, the transport's tables and the analytic
ICI counters against JAX's namesakes, ``plan_table_widths`` and the
block-keyed build against JAX's, the distributed builder against the
block-keyed build leaf for leaf, and the mesh round at S = 1, 2, 4 and 8
against the port's local round on the same plan, dense, sparse, auto and
packed. The JAX halves that compile (plan builds, transport tables,
counters) are pinned in ``tests/jax_pins.json`` (group ``mesh_facts``)
and the carried-across plan's leaves come from a child process
(``jax_in_child``); the JAX mesh runs' results are pinned too
(``test_torch_mesh_pins.py`` rechecks them).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import matching_topology as jmt
from tpu_gossip.dist import transport as jt
from tpu_gossip.kernels import permute as jperm
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.control import compile_control
from tpu_gossip_torch.core import matching_topology as tmt
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.dist import transport as tt
from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
from tpu_gossip_torch.growth import compile_growth, matching_admit_rows
from tpu_gossip_torch.kernels import permute as tperm
from tpu_gossip_torch.kernels.liveness import compile_quorum
from tpu_gossip_torch.sim.engine import simulate
from tpu_gossip_torch.sim.stages import compile_pipeline
from tpu_gossip_torch.traffic import compile_stream
from tpu_gossip_torch.utils.digest import state_digest, stats_digest
from tests.jax_pins import CASES, CHAOS, SIEGE_SMALL, leaf_digest, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SHARDS = (1, 2, 4, 8)


def arr(leaf):
    """A ``tests.jax_pins._leaf`` back into numpy (lists of them too)."""
    return [arr(x) for x in leaf] if isinstance(leaf, list) else np.asarray(leaf["data"], dtype=leaf["dtype"])


def digests(fin, stats) -> dict:
    return {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats)}


def ici_words(ici) -> dict:
    return {f: int(getattr(ici, f).sum()) for f in ici._fields}


def mesh_setup(n: int, shards: int, mode: str = "push_pull", plane: str = "", builder: str = "local"):
    """The port's twin of ``tests.jax_pins.matching_mesh_run``'s set-up:
    ``(graph, plan on the mesh, cfg, state on the mesh, mesh, to_rows)``."""
    mesh = tdist.make_mesh(shards, device="cpu")
    fanout = None if mode == "flood" else 2
    grow_rows = 16 if plane == "growth" else 0
    if builder == "dist":
        g, plan = tdist.matching_powerlaw_graph_dist(n, mesh, fanout=fanout, key=prng.key(1, "cpu"),
                                                     growth_rows=grow_rows)
    else:
        g, plan = tmt.matching_powerlaw_graph_sharded(n, shards, fanout=fanout, key=prng.key(1, "cpu"),
                                                      growth_rows=grow_rows, device="cpu")
    plan = tdist.shard_matching_plan(plan, mesh)
    churn = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=2) if plane == "churn" else {}
    if plane == "growth":
        churn = dict(rewire_slots=2)  # growth edges ride the re-wiring plane
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=2, mode=mode, **churn)

    def to_rows(ids):
        ids = np.asarray(ids)
        return (ids // plan.n_per) * plan.n_blk + (ids % plan.n_per)

    st = init_swarm(g.as_padded_graph(), cfg, origins=to_rows([0, 5]), exists=g.exists, key=prng.key(3, "cpu"),
                    device="cpu")
    return g, plan, cfg, tdist.shard_swarm(st, mesh), mesh, to_rows


def mesh_planes(plan, shards: int, plane: str, rounds: int, to_rows, pipeline=None) -> dict:
    """The port's twin of ``matching_mesh_run``'s plane."""
    kw = {}
    n_real = plan.n_per * shards
    if plane in ("scenario", "quorum"):
        kw["scenario"] = compile_scenario(scenario_from_dict(CHAOS if plane == "scenario" else SIEGE_SMALL),
                                          n_peers=n_real, n_slots=plan.n, total_rounds=rounds, node_map=to_rows,
                                          shard_ranges=tdist.shard_ranges(shards, plan.n_blk), n_shards=shards,
                                          device="cpu")
    if plane == "quorum":
        kw["liveness"] = compile_quorum(3, 4, 2)
    if plane == "growth":
        joins = 8 * shards
        kw["growth"] = compile_growth(n_initial=n_real, target=n_real + joins, n_slots=plan.n, joins_per_round=4,
                                      attach_m=2, admit_rows=matching_admit_rows(plan, joins), device="cpu")
    if plane == "stream":
        kw["stream"] = compile_stream(rate=1.5, msg_slots=8, ttl=6, origin_rows=to_rows(np.arange(n_real)),
                                      k_hashes=1, device="cpu")
    if plane == "control":
        kw["control"] = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=4, device="cpu")
    if pipeline is not None:
        kw["pipeline"] = compile_pipeline(pipeline)
    return kw


def mesh_run(n: int, shards: int, mode: str = "push_pull", rounds: int = 8, transport: str = "dense",
             packed: bool = False, plane: str = "", pipeline=None, builder: str = "local", ici: bool = False,
             local: bool = False) -> dict:
    """The port's twin of ``tests.jax_pins.matching_mesh_run``; ``local``
    runs the same plan and planes through the local engine instead."""
    g, plan, cfg, st, mesh, to_rows = mesh_setup(n, shards, mode, plane, builder)
    kw = mesh_planes(plan, shards, plane, rounds, to_rows, pipeline)
    st = pack_state(st) if packed else st
    if local:
        fin, stats = simulate(st, cfg, rounds, plan, **kw)
        return digests(unpack_state(fin) if packed else fin, stats)
    tr = None if transport == "dense" else tdist.build_transport(plan, mode=transport, mesh=mesh)
    out = tdist.simulate_dist(st, cfg, plan, mesh, rounds, transport=tr, collect_ici=ici, **kw)
    fin, stats = (out[0], out[1][0]) if ici else out
    res = digests(unpack_state(fin) if packed else fin, stats)
    if ici:
        res["ici"] = ici_words(out[1][1])
    return res


# ------------------------------------------------------------ the exchange


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_transposes_equal_jax_bijection(s):
    """Each transpose stage on the stacked shard blocks (split the lanes,
    exchange, transpose-reshape) equals JAX's global ``transpose_pass`` /
    ``untranspose_pass``, and the two are inverse."""
    r = 8 * s * 3
    x = np.random.default_rng(s).integers(-2**31, 2**31, (r, 128), dtype=np.int64).astype(np.int32)
    xt = torch.from_numpy(x).view(s, r // s, 128)
    got_t = tperm.transpose_pass_sharded(xt, s)
    got_u = tperm.untranspose_pass_sharded(xt, s)
    np.testing.assert_array_equal(got_t.reshape(r, 128).numpy(), np.asarray(jperm.transpose_pass(jnp.asarray(x))))
    np.testing.assert_array_equal(got_u.reshape(r, 128).numpy(), np.asarray(jperm.untranspose_pass(jnp.asarray(x))))
    assert torch.equal(tperm.untranspose_pass_sharded(got_t, s), xt)
    with pytest.raises(ValueError, match="128 % n_shards"):
        tperm.transpose_pass_sharded(torch.zeros((3, 8, 128), dtype=torch.int32), 3)


@pytest.mark.parametrize("s", SHARDS)
def test_sparse_transposes_equal_dense(s):
    """The compact lanes rebuild the dense lanes' blocks exactly, hub rows
    on the dense sub-lane (local rows for "t", global rows grouped by
    destination for "tinv"), leaf rows compacted to the budget, a sentinel
    in a hub table."""
    g = torch.Generator().manual_seed(s)
    per, h, cap = 16, 3, 6
    r, w = per * s, 128 // s
    hub_loc = torch.stack([torch.randperm(per, generator=g)[:h] for _ in range(s)]).to(torch.int32)
    hub_loc[0, -1] = per
    hub_glob = torch.where(hub_loc < per, hub_loc + torch.arange(s)[:, None] * per, r).to(torch.int32)
    x = torch.zeros((s, per, 128), dtype=torch.int32)
    for i in range(s):
        rows = torch.randperm(per, generator=g)[:cap]
        x[i, rows, torch.randint(0, 128, (cap,), generator=g)] = torch.randint(1, 1000, (cap,), generator=g,
                                                                               dtype=torch.int32)
        x[i, hub_loc[i][hub_loc[i] < per].long()] = 7
    assert torch.equal(tt.transpose_pass_sparse(x, s, hub_loc, cap), tperm.transpose_pass_sharded(x, s))
    slab = torch.zeros((s, r, w), dtype=torch.int32)
    for i in range(s):
        for d in range(s):
            rows = torch.randperm(per, generator=g)[:cap] + d * per
            slab[i, rows, torch.randint(0, w, (cap,), generator=g)] = 3
        slab[i, hub_glob[hub_glob < r].long()] = 9
    y = slab.transpose(1, 2).reshape(s, per, 128)
    assert torch.equal(tt.untranspose_pass_sparse(y, s, hub_glob, cap), tperm.untranspose_pass_sharded(y, s))


@pytest.mark.parametrize("s", (2, 8))
def test_pipeline_transport_equals_dense_pipeline(s):
    """The sharded pipeline on a plan's transport lanes equals the plain
    pipeline whenever its gates tell the truth: a hub-heavy plane with few
    leaf words (the hub lane compacts), a plane under the budget (every
    lane compacts), and the dense fallbacks."""
    _, plan = tmt.matching_powerlaw_graph_sharded(6000, s, fanout=2, key=prng.key(1, "cpu"), device="cpu")
    tr = tdist.build_transport(plan, "sparse", hub_rows_frac=1 / 8)
    assert "hub" in tr.stage_mode and tr.hub_tables[0].shape[1] > 0
    g = torch.Generator().manual_seed(s)
    leafy = torch.zeros((plan.rows, 128), dtype=torch.int32)
    hits = torch.randint(0, plan.rows * 128, (tr.budget // 2,), generator=g)
    leafy.view(-1)[hits] = torch.randint(1, 2**30, (len(hits),), generator=g, dtype=torch.int32)
    hubby = leafy.clone()
    hubby[~tr.leaf_slots] |= 5
    for x in (leafy, hubby):
        want = tperm.apply_pipeline(x, plan.stages)
        assert torch.equal(tperm.apply_pipeline(x, plan.stages, n_shards=s), want)
        nz = x != 0
        fits_leaf = int((nz & tr.leaf_slots).sum()) <= tr.budget
        fits_total = int(nz.sum()) <= tr.budget
        assert fits_leaf
        for take_leaf in (True, False):
            for take_total in ((True, False) if fits_total else (False,)):
                got = tperm.apply_pipeline(x, plan.stages, n_shards=s, lanes=tr.lanes(take_leaf, take_total))
                assert torch.equal(got, want), (take_leaf, take_total)


# -------------------------------------------------- tables and counters


@pytest.mark.parametrize("s,mode,frac,pin", [(8, "auto", 1 / 32, "tables_s8_auto"),
                                             (2, "sparse", 1 / 8, "tables_s2_sparse_frac8")])
def test_matching_transport_tables_equal_jax(s, mode, frac, pin):
    """``build_transport`` of a sharded plan: the budget, the auto gate,
    the stage modes, the leaf slots and every hub table equal JAX's
    (pinned: ``tests.jax_pins.transport_tables``)."""
    want = pinned("mesh_facts", pin)
    tp = tmt.matching_powerlaw_graph_sharded(1500, s, fanout=2, key=prng.key(1, "cpu"), device="cpu")[1]
    got = tdist.build_transport(tp, mode=mode, hub_rows_frac=frac)
    for f in ("engine", "mode", "active", "budget", "hub_degree_min", "n_shards", "fingerprint"):
        assert getattr(got, f) == want[f], f
    assert list(got.stage_mode) == want["stage_mode"]
    assert leaf_digest(got.leaf_slots.numpy()) == want["leaf_slots"]
    assert [t.tolist() for t in got.hub_tables] == want["hub_tables"]
    got.check_matches_plan(tp)
    with pytest.raises(ValueError, match="bucketed exchange"):
        got.check_matches_graph(None)


def test_bucketed_transport_and_refusals_equal_jax():
    """The bucketed compact lane's budget and auto gate equal JAX's on a
    partition, and so does the hier transport's (ROADMAP item 11c, ported
    since) on 2 and 4 host rows, with JAX's errors on one row and on rows
    that do not divide the mesh; a bad mode is JAX's error."""
    from tests.jax_pins import bucketed_setup

    from tpu_gossip_torch.convert import SHARDED_LEAVES, SHARDED_STATIC, sharded_graph_from_jax

    jsg = bucketed_setup(600, 3, 0, 4)[0]
    tsg = sharded_graph_from_jax({k: np.asarray(getattr(jsg, k)) for k in SHARDED_LEAVES},
                                 {k: getattr(jsg, k) for k in SHARDED_STATIC}, device="cpu")
    for mode in ("sparse", "auto"):
        want, got = jt.build_transport(jsg, mode=mode), tdist.build_transport(tsg, mode=mode)
        assert (got.budget, got.active, got.engine, got.fingerprint) == (want.budget, want.active, want.engine,
                                                                        want.fingerprint)
        got.check_matches_graph(tsg)
    for hosts in (2, 4):
        want, got = jt.build_transport(jsg, mode="hier", hosts=hosts), tdist.build_transport(tsg, mode="hier",
                                                                                           hosts=hosts)
        fields = ("engine", "mode", "active", "budget", "n_shards", "fingerprint", "hosts", "dcn_budget")
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
        got.check_matches_graph(tsg)
    for hosts in (1, 3):
        with pytest.raises(ValueError) as got_err:
            tdist.build_transport(tsg, mode="hier", hosts=hosts)
        with pytest.raises(ValueError) as want_err:
            jt.build_transport(jsg, mode="hier", hosts=hosts)
        assert str(got_err.value) == str(want_err.value)
    with pytest.raises(ValueError) as got_err:
        tdist.build_transport(tsg, mode="dense")
    with pytest.raises(ValueError) as want_err:
        jt.build_transport(jsg, mode="dense")
    assert str(got_err.value) == str(want_err.value)


@pytest.mark.parametrize("s,m", [(1, 16), (8, 12)])
def test_ici_counters_equal_jax(s, m):
    """``ici_round_matching`` (dense and sparse, with and without a pull
    answer plane) and ``ici_round_bucketed`` (merged and split) are
    integer-equal to JAX's on seeded planes (pinned:
    ``tests.jax_pins.ici_counter_cases``, drawn in the same order), and so
    are the matching plan's dense wire declarations."""
    from tests.jax_pins import bucketed_setup

    from tpu_gossip_torch.convert import SHARDED_LEAVES, SHARDED_STATIC, sharded_graph_from_jax
    from tpu_gossip_torch.dist import matching_mesh as tmm

    want = pinned("mesh_facts", f"ici_s{s}_m{m}")
    tp = tmt.matching_powerlaw_graph_sharded(1500, s, fanout=2, key=prng.key(1, "cpu"), device="cpu")[1]
    rng = np.random.default_rng(s + m)
    ttr = tdist.build_transport(tp, "sparse")
    got = {"matching": [], "bucketed": []}
    for density in (0.0005, 0.01, 0.5):
        tx = torch.from_numpy(rng.random((tp.n, m)) < density)
        ans = torch.from_numpy(rng.random((tp.n, m)) < density)
        for trans in (None, ttr):
            for a in (None, ans):
                got["matching"].append(ici_dict(tt.ici_round_matching(tp, trans, m, tx, a)))
    jsg = bucketed_setup(600, 3, 0, s)[0]
    tsg = sharded_graph_from_jax({k: np.asarray(getattr(jsg, k)) for k in SHARDED_LEAVES},
                                 {k: getattr(jsg, k) for k in SHARDED_STATIC}, device="cpu")
    tb = tdist.build_transport(tsg, "sparse")
    for density in (0.002, 0.3):
        tx_any = torch.from_numpy(rng.random(tsg.n_pad) < density)
        ans_any = torch.from_numpy(rng.random(tsg.n_pad) < density)
        for merged, a in ((True, None), (False, ans_any)):
            for trans in (None, tb):
                got["bucketed"].append(ici_dict(tt.ici_round_bucketed(tsg, trans, 2, tx_any, a, merged)))
    got["wire"] = [tmm.dense_wire_words(tp, 16, mode, fo, bp) for mode in ("push", "push_pull", "flood")
                   for fo in (False, True) for bp in (False, True)]
    assert got == want


def ici_dict(ici) -> dict:
    return {f: int(getattr(ici, f)) for f in ici._fields}


def test_ici_totals_equal_jax():
    """The hi/lo totals fold as JAX's, past the radix too."""
    (rounds,) = CASES["mesh_facts"]["totals"][1]
    got = tt.zero_ici_totals()
    for r in rounds:
        got = tt.accumulate_ici(got, tt.IciRound(*(torch.tensor(v) for v in r)))
    assert got.words() == pinned("mesh_facts", "totals")
    assert tt.header_spec(4) == ((4,), torch.int32)


# ------------------------------------------------------------ the builders


@pytest.mark.parametrize("n,s", [(1_000_000, 1), (1_000_000, 8), (300_000, 4), (5000, 2)])
def test_plan_table_widths_equal_jax(n, s):
    assert tmt.plan_table_widths(n, n_shards=s) == jmt.plan_table_widths(n, n_shards=s)


@pytest.mark.parametrize("s,csr,growth", [(4, False, 7), (8, True, 3)])
def test_block_keyed_build_equals_jax(s, csr, growth):
    """``matching_powerlaw_graph_sharded(block_keys=True)``: per-shard
    fold_in tables and per-shard sentinels, every leaf equal to JAX's (a
    sha256 a leaf of its dtype and bytes, pinned)."""
    want = pinned("mesh_facts", f"block_keys_s{s}")
    assert CASES["mesh_facts"][f"block_keys_s{s}"][1] == [1500, s, 1, 5, True, csr, growth]
    tg, tp = tmt.matching_powerlaw_graph_sharded(1500, s, fanout=1, key=prng.key(5, "cpu"), block_keys=True,
                                                 export_csr=csr, growth_rows=growth, device="cpu")
    got = {f: leaf_digest(tuple(t.numpy() for t in getattr(tp, f)) if f in ("lanes", "lanes_inv")
                          else getattr(tp, f).numpy()) for f in ("lanes", "m3", "lanes_inv", "valid", "deg_other",
                                                                 "deg_real")}
    got.update({f: leaf_digest(getattr(tg, f).numpy()) for f in ("row_ptr", "col_idx", "exists")})
    assert got == want
    assert not torch.equal(tp.lanes[0], tmt.matching_powerlaw_graph_sharded(
        1500, s, fanout=1, key=prng.key(5, "cpu"), growth_rows=growth, device="cpu")[1].lanes[0])


@pytest.mark.parametrize("s,csr,growth", [(1, True, 0), (2, False, 5), (4, True, 9), (8, True, 0)])
def test_dist_builder_equals_block_keyed_build(s, csr, growth):
    """``matching_powerlaw_graph_dist``, shard by shard on the mesh, equals
    the block-keyed local build on every plan leaf and graph array."""
    mesh = tdist.make_mesh(s, device="cpu")
    g1, p1 = tmt.matching_powerlaw_graph_sharded(4000, s, fanout=2, key=prng.key(3, "cpu"), block_keys=True,
                                                 export_csr=csr, growth_rows=growth, device="cpu")
    g2, p2 = tdist.matching_powerlaw_graph_dist(4000, mesh, fanout=2, key=prng.key(3, "cpu"), export_csr=csr,
                                                growth_rows=growth)
    for f in ("lanes", "lanes_inv"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(p1, f), getattr(p2, f)))
    for f in ("m3", "valid", "deg_other", "deg_real"):
        a, b = getattr(p1, f), getattr(p2, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in ("row_ptr", "col_idx", "exists"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f
    for f in ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk", "per_rows", "local_classes"):
        assert getattr(p1, f) == getattr(p2, f), f
    with pytest.raises(ValueError, match="must divide 128"):
        tdist.matching_powerlaw_graph_dist(4000, tdist.make_mesh(3, device="cpu"))


# ------------------------------------------- the mesh round against local


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("mode", ["push_pull", "push", "flood"])
def test_mesh_round_equals_local_round(s, mode):
    """The mesh's rounds equal the local engine's on the same plan, bit for
    bit, under the dense, sparse and auto transports and packed."""
    want = mesh_run(1500, s, mode, rounds=6, local=True)
    for transport in ("dense", "sparse", "auto"):
        tt.reset_lane_counts()
        assert mesh_run(1500, s, mode, rounds=6, transport=transport) == want, transport
        lanes = tt.lane_counts()
        if transport == "dense":
            assert lanes == {"compact": 0, "dense": 0}
        if transport == "sparse":  # compact lanes while the planes are thin
            assert lanes["compact"] > 0
    assert mesh_run(1500, s, mode, rounds=6, transport="sparse", packed=True) == want


def test_mesh_round_checks_its_layout():
    """A plan laid out for another shard count, a state off the mesh's
    device, a bucketed transport and a shard plan are refused."""
    g, plan, cfg, st, mesh, _ = mesh_setup(1200, 2)
    with pytest.raises(ValueError, match="laid out for 2 shards"):
        tdist.gossip_round_dist(st, cfg, plan, tdist.make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="shard_plan"):
        tdist.gossip_round_dist(st, cfg, plan, mesh, object())
    with pytest.raises(ValueError, match="fanout=2 but cfg.fanout=3"):
        tdist.gossip_round_dist(st, SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=3, mode="push"), plan, mesh)
    bad = tt.Transport(engine="bucketed")
    with pytest.raises(ValueError, match="matching transposes"):
        tdist.gossip_round_dist(st, cfg, plan, mesh, transport=bad)


def test_sharded_jax_plan_carries_across():
    """A sharded JAX plan (``mesh_shards`` 4, int8 lane tables, int16
    degree tables, growth rows) carried across by ``convert.plan_from_jax``
    equals the port's own build leaf for leaf, keeps its layout fields, and
    runs the mesh round as the port's plan does."""
    from tpu_gossip_torch import convert

    want = jax_in_child("tests.jax_pins", "sharded_plan_leaves", 1200, 4, 2, 1, False, True, 3)
    cp = convert.plan_from_jax({k: arr(v) for k, v in want["plan"].items()}, want["static"], device="cpu")
    g, tp = tmt.matching_powerlaw_graph_sharded(1200, 4, fanout=2, key=prng.key(1, "cpu"), growth_rows=3,
                                                device="cpu")
    assert (cp.mesh_shards, cp.per_rows, cp.n_blk, cp.local_classes) == (4, tp.per_rows, tp.n_blk, tp.local_classes)
    for f in ("m3", "valid", "deg_other", "deg_real"):
        a, b = getattr(cp, f), getattr(tp, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert cp.lanes[0].dtype == torch.int8 or tp.per_rows % 32
    mesh = tdist.make_mesh(4, device="cpu")
    cfg = SwarmConfig(n_peers=tp.n, msg_slots=8, fanout=2, mode="push_pull")
    st = init_swarm(g.as_padded_graph(), cfg, origins=[0], exists=g.exists, key=prng.key(3, "cpu"), device="cpu")
    a = tdist.simulate_dist(st, cfg, tdist.shard_matching_plan(cp, mesh), mesh, 3)
    b = tdist.simulate_dist(st, cfg, tdist.shard_matching_plan(tp, mesh), mesh, 3)
    assert digests(*a) == digests(*b)
