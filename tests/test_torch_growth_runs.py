"""The cells of ``tests/sim/test_growth.py`` as port-against-JAX
equalities on the CPU: each growing run (the local engine, its packed
twin, the bucketed mesh at S = 1 and 3, the run to coverage) equal to
JAX's through ``state_digest``/``stats_digest``, ``degree_gamma`` within
1e-5, and the cell's own law holding on the port's run: admission to the
target and the registry, degree-preferential attachment, zero-join runs
equal to fixed-n ones, the S=8 matching layout's local run (the mesh half
is the sharded matching engine's slice), join_burst waves, churn, the
remat fold and the credit books; mid-growth and pre-growth checkpoints
across the packages; and the sim half of
``tests/conformance/test_growth_bootstrap.py`` (its socket half waits for
the socket cluster's slice)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import faults as jfaults
from tpu_gossip import growth as jg
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.core.topology import fit_powerlaw_gamma
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip_torch import faults as tfaults
from tpu_gossip_torch import growth as tg
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.jax_pins import pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

from tests.test_torch_growth import _growth_pair, _seed_graph, sharded8  # noqa: F401

N0, CAP, ATTACH = 64, 128, 3


# ------------------------------------------------------------ the cells of tests/sim/test_growth.py

def _grown_kw(n0=N0, cap=CAP, target=None, rate=8, attach=ATTACH, seed=0, graph_seed=0, max_join_burst=0,
              **cfg_kw):
    """(graph, exists, config kwargs, growth kwargs, seed) of
    tests/sim/test_growth.py::grown_setup's flat padded layout."""
    target = cap if target is None else target
    graph, exists = jg.pad_graph_for_growth(_seed_graph(n0, seed=graph_seed), cap)
    kw = dict(n_peers=cap, msg_slots=cfg_kw.pop("msg_slots", 4), fanout=cfg_kw.pop("fanout", 2),
              mode=cfg_kw.pop("mode", "push_pull"), rewire_slots=max(attach, cfg_kw.pop("rewire_slots", 0)), **cfg_kw)
    gkw = dict(n_initial=n0, target=target, n_slots=cap, joins_per_round=rate, attach_m=attach,
               max_join_burst=max_join_burst)
    return graph, exists, kw, gkw, seed


def _grown(**grow_kw):
    """The port's (cfg, state, growth) of :func:`_grown_kw`."""
    graph, exists, kw, gkw, seed = _grown_kw(**grow_kw)
    tc = TConfig(**kw)
    ts = t_init(graph, tc, origins=[0], exists=torch.from_numpy(exists), key=prng.key(seed, "cpu"), device="cpu")
    return tc, ts, tg.compile_growth(**gkw, device="cpu")


def _grown_jax(**grow_kw):
    """The JAX package's (cfg, state, growth) of :func:`_grown_kw`."""
    graph, exists, kw, gkw, seed = _grown_kw(**grow_kw)
    jc = JConfig(**kw)
    js = j_init(graph, jc, origins=[0], exists=jnp.asarray(exists), key=jax.random.key(seed))
    return jc, js, jg.compile_growth(**gkw)


_WAVE = {"name": "wave", "phases": [{"name": "w", "start": 2, "end": 5, "join_burst": 6}]}
_STORM = {"name": "storm+wave", "phases": [{"name": "sw", "start": 2, "end": 5, "join_burst": 6, "churn_leave": 0.2}]}

# the growing runs whose JAX halves are pinned in tests/jax_pins.json (group
# growth_runs): name -> (_grown kwargs, rounds, scenario dict or None)
GROWN_RUNS = {
    "admits": ({}, 12, None),
    "preferential": (dict(n0=200, cap=600, rate=40, seed=2, graph_seed=3, msg_slots=1, mode="push"), 12, None),
    "zero_exhausted": (dict(churn_leave_prob=0.02, churn_join_prob=0.2), 10, None),
    "wave": (dict(rate=2, max_join_burst=6), 12, _WAVE),
    "storm": (dict(rate=2, max_join_burst=6), 12, _STORM),
    "composes": (dict(churn_leave_prob=0.05, churn_join_prob=0.3, rewire_compact_cap=40), 16, None),
    "credit": (dict(churn_leave_prob=0.05, churn_join_prob=0.5), 12, None),
    "to_coverage": (dict(rate=4), None, None),
}


def _scenario(pkg, d):
    return None if d is None else pkg.compile_scenario(pkg.scenario_from_dict(d), n_peers=N0, n_slots=CAP,
                                                       total_rounds=12, **({} if pkg is jfaults else {"device": "cpu"}))


def jax_grown_run(name: str) -> dict:
    """The JAX half of the growing run ``name`` (:data:`GROWN_RUNS`): the
    final state's and the stats' digests with the coverage and
    ``degree_gamma`` columns; ``to_coverage`` runs ``run_until_coverage``
    to 0.99 within 40 rounds; ``admits`` adds the remat fold of the
    12-round state and 6 rounds after it."""
    grow_kw, rounds, scen = GROWN_RUNS[name]
    jc, js, jgp = _grown_jax(**grow_kw)
    if rounds is None:
        return {"state_digest": j_state_digest(je.run_until_coverage(js, jc, 0.99, 40, growth=jgp))}
    jf, jst = je.simulate(js, jc, rounds, None, "fused", _scenario(jfaults, scen), jgp)
    out = {"state_digest": j_state_digest(jf), "stats_digest": j_stats_digest(jst),
           "coverage": np.asarray(jst.coverage).tolist(), "degree_gamma": np.asarray(jst.degree_gamma).tolist()}
    if name == "admits":
        tc, ts, _ = _grown(**grow_kw)
        jfolded, _ = je.rematerialize_rewired(jf, jc, te.remat_capacity(ts, tc))
        out["remat_folded"] = j_state_digest(jfolded)  # before the donating simulate
        jfin, _ = je.simulate(jfolded, jc, 6, None, "fused", None, jgp)
        out["remat_fin"] = j_state_digest(jfin)
    return out


def _run_both(name, packed_twin=False):
    """The port's growing run ``name`` against its pinned JAX half."""
    grow_kw, rounds, scen = GROWN_RUNS[name]
    want = pinned("growth_runs", name)
    tc, ts, tgp = _grown(**grow_kw)
    tscen = _scenario(tfaults, scen)
    tf, tst = te.simulate(ts, tc, rounds, None, "fused", scenario=tscen, growth=tgp)
    assert t_state_digest(tf) == want["state_digest"]
    assert t_stats_digest(tst) == want["stats_digest"]
    np.testing.assert_array_equal(tst.coverage.numpy(), np.asarray(want["coverage"], np.float32))
    np.testing.assert_allclose(tst.degree_gamma.numpy(), np.asarray(want["degree_gamma"], np.float32), rtol=1e-5)
    if packed_twin:
        pf, pst = te.simulate(pack_state(ts), tc, rounds, None, "fused", scenario=tscen, growth=tgp)
        assert t_state_digest(unpack_state(pf)) == t_state_digest(tf) and t_stats_digest(pst) == t_stats_digest(tst)
        np.testing.assert_array_equal(pst.degree_gamma.numpy(), tst.degree_gamma.numpy())
    return tf, tst


def test_growth_admits_to_target_and_fills_registry():
    fin, stats = _run_both("admits", packed_twin=True)
    members = stats.n_members.numpy()
    assert members[0] == N0 + 8 and members[-1] == CAP and (np.diff(members) >= 0).all()
    grown = np.arange(N0, CAP)
    jr, ab = fin.join_round.numpy(), fin.admitted_by.numpy()
    assert (jr[:N0] == 0).all() and (jr[grown] >= 1).all() and (np.diff(jr[grown]) >= 0).all()
    assert (ab[grown] >= 0).all() and fin.rewired.numpy()[grown].all()
    tg_ = fin.rewire_targets.numpy()[grown, :ATTACH]
    assert (tg_ >= 0).all() and all(len(set(t)) == ATTACH and r not in t for r, t in zip(grown, tg_))
    assert int(fin.degree_credit.sum()) == ATTACH * len(grown)
    deg = tg.realized_degrees(fin.row_ptr, fin.exists, fin.rewired, fin.rewire_targets, fin.degree_credit).numpy()
    base = (fin.row_ptr[1:] - fin.row_ptr[:-1]).numpy()
    assert (deg[grown] >= ATTACH).all() and deg.sum() == base[:N0].sum() + 2 * ATTACH * len(grown)


def test_growth_attachment_is_degree_preferential():
    graph = _seed_graph(200, seed=3)
    fin, _ = _run_both("preferential")
    credit, deg0 = fin.degree_credit.numpy()[:200], graph.degrees
    assert credit[np.argsort(deg0)[-10:]].mean() > 3 * credit[np.argsort(deg0)[:100]].mean()


@pytest.mark.parametrize("shape", ["empty", "exhausted"])
def test_zero_join_growth_is_bit_identical_to_fixed_n(shape):
    """A schedule with nothing to admit reproduces ``growth=None`` bit for
    bit in the port, as in JAX (and the port's runs equal JAX's)."""
    tc, ts, tgp = _grown(churn_leave_prob=0.02, churn_join_prob=0.2)
    if shape == "empty":
        tgp = tg.compile_growth(n_initial=N0, target=N0, n_slots=CAP, joins_per_round=8, attach_m=ATTACH,
                                device="cpu")
        start, rounds = ts, 10
    else:
        start, _ = _run_both("zero_exhausted")
        assert bool(start.exists.all())
        rounds = 8
    base, bst = te.simulate(start, tc, rounds)
    grown, gst = te.simulate(start, tc, rounds, growth=tgp)
    assert t_state_digest(grown) == t_state_digest(base) and t_stats_digest(gst) == t_stats_digest(bst)


def test_matching_growth_on_the_sharded_layout_equals_jax_local(sharded8):
    """The local half of test_matching_growth_local_vs_sharded_bit_identical:
    a growing run over the S=8 layout's global classes view, flood and
    push_pull, equals JAX's local run; admissions stay in the reserved
    rows."""
    (jgr, jp), (tgr, tp) = sharded8
    admit = jg.matching_admit_rows(jp, 160)
    for mode in ("flood", "push_pull"):
        kw = dict(n_peers=jp.n, msg_slots=4, fanout=2, mode=mode, rewire_slots=ATTACH)
        js = j_init(jgr.as_padded_graph(), JConfig(**kw), origins=[0, 5], exists=jgr.exists, key=jax.random.key(3))
        ts = t_init(tgr.as_padded_graph(), TConfig(**kw), origins=[0, 5], exists=tgr.exists, key=prng.key(3, "cpu"),
                    device="cpu")
        gkw = dict(n_initial=800, target=960, n_slots=jp.n, joins_per_round=16, attach_m=ATTACH, admit_rows=admit)
        jgp, tgp = _growth_pair(**gkw)
        jf, jst = je.simulate(js, JConfig(**kw), 8, jp, "fused", None, jgp)
        tf, tst = te.simulate(ts, TConfig(**kw), 8, tp, growth=tgp)
        assert t_state_digest(tf) == j_state_digest(jf) and t_stats_digest(tst) == j_stats_digest(jst)
        np.testing.assert_allclose(tst.degree_gamma.numpy(), np.asarray(jst.degree_gamma), rtol=1e-5)
        assert int(tst.n_members[-1]) == 928  # 800 + 8 * 16
        leaked = tf.exists.numpy() & ~tgr.exists.numpy()
        assert set(np.flatnonzero(leaked).tolist()) <= set(admit.tolist())


def test_device_gamma_track_matches_host_estimator():
    fin, stats = _run_both("admits")
    deg = tg.realized_degrees(fin.row_ptr, fin.exists, fin.rewired, fin.rewire_targets, fin.degree_credit)
    live = fin.alive & ~fin.declared_dead
    host = fit_powerlaw_gamma(deg.numpy()[live.numpy()], d_min=4)
    assert abs(float(tg.hill_gamma_device(deg, live, 4)) - host) < 1e-4
    assert abs(float(stats.degree_gamma[-1]) - host) < 1e-4


def test_join_burst_phase_adds_admissions_and_composes_with_a_storm():
    _, stats = _run_both("wave", packed_twin=True)
    per_round = np.diff(np.concatenate([[N0], stats.n_members.numpy()]))
    np.testing.assert_array_equal(per_round[:5], [2, 2, 8, 8, 8])
    assert (per_round[5:] <= 2).all()
    _, stats2 = _run_both("storm")
    assert int(stats2.n_members[4]) == int(stats.n_members[4]) and int(stats2.n_alive[4]) < int(stats.n_alive[4])


def test_growth_composes_with_churn_rewire():
    fin, stats = _run_both("composes", packed_twin=True)
    assert int(stats.n_members[-1]) == CAP and int(stats.n_alive[-1]) > CAP * 0.6
    assert float(fin.coverage(0)) > 0.5


def test_remat_folds_growth_edges_and_zeroes_credit():
    want = pinned("growth_runs", "admits")
    tc, ts, tgp = _grown()
    cap = te.remat_capacity(ts, tc)
    mid, _ = _run_both("admits")
    folded, overflow = te.rematerialize_rewired(mid, tc, cap)
    assert t_state_digest(folded) == want["remat_folded"] and int(overflow) == 0
    assert not folded.rewired.any() and not folded.degree_credit.any()
    keys = ("row_ptr", "exists", "rewired", "rewire_targets", "degree_credit")
    np.testing.assert_array_equal(tg.realized_degrees(*(getattr(folded, k) for k in keys)).numpy(),
                                  tg.realized_degrees(*(getattr(mid, k) for k in keys)).numpy())
    fin, _ = te.simulate(folded, tc, 6, growth=tgp)
    assert t_state_digest(fin) == want["remat_fin"] and float(fin.coverage(0)) > 0.9


def test_credit_books_balance_under_churn_rejoin():
    tc, ts, _ = _grown(churn_leave_prob=0.05, churn_join_prob=0.5)
    cap = te.remat_capacity(ts, tc)
    mid, _ = _run_both("credit")
    credit, rew, tgt = mid.degree_credit.numpy(), mid.rewired.numpy(), mid.rewire_targets.numpy()
    assert (credit >= 0).all() and rew.any() and credit.sum() == (tgt[rew] >= 0).sum()
    keys = ("row_ptr", "exists", "rewired", "rewire_targets", "degree_credit")
    before = tg.realized_degrees(*(getattr(mid, k) for k in keys)).numpy()
    row_ptr, col_idx = mid.row_ptr.numpy(), mid.col_idx.numpy()
    stale = np.asarray([rew[col_idx[row_ptr[r]:row_ptr[r + 1]]].sum() for r in range(len(rew))])
    folded, _ = te.rematerialize_rewired(mid, tc, cap)
    after = tg.realized_degrees(*(getattr(folded, k) for k in keys)).numpy()
    np.testing.assert_array_equal(after[rew], before[rew])
    np.testing.assert_array_equal(after[~rew], before[~rew] - stale[~rew])


def test_growth_stage_refuses_a_narrow_rewire_plane_as_jax():
    tc, ts, tgp = _grown()
    narrow = dataclasses.replace(ts, rewire_targets=ts.rewire_targets[:, :1])
    with pytest.raises(ValueError, match="rewire_slots"):
        te.simulate(narrow, tc, 2, growth=tgp)
    with pytest.raises(ValueError, match="cfg.rewire_slots >= 3"):
        te.simulate(ts, dataclasses.replace(tc, rewire_slots=2), 2, growth=tgp)


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_growth_equals_jax_mesh(s):
    """The bucketed engine on a padded CSR, admission order through
    ``position``: the port's mesh run equals the JAX mesh's, and its
    packed twin equals it."""
    from tpu_gossip.dist import simulate_dist as j_sim_dist

    from tpu_gossip_torch import dist as tdist
    from tests.test_torch_dist import _build

    graph, exists = jg.pad_graph_for_growth(_seed_graph(150, seed=4), 200)
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, s, exists=exists, m=8, mode="push", fanout=2,
                                                  rewire_slots=ATTACH)
    _, _, position = tdist.partition_graph(graph, s, seed=1, device="cpu")
    gkw = dict(n_initial=150, target=200, n_slots=tsg.n_pad, joins_per_round=6, attach_m=ATTACH,
               node_map=lambda ids: position[np.asarray(ids)])
    jgp, tgp = _growth_pair(**gkw)
    jfin, jst = j_sim_dist(js, jc, jsg, jm, 10, None, None, jgp)
    tfin, tst = tdist.simulate_dist(ts, tc, tsg, tm, 10, growth=tgp)
    assert t_state_digest(tfin) == j_state_digest(jfin) and t_stats_digest(tst) == j_stats_digest(jst)
    assert int(tst.n_members[-1]) == 200
    pfin, pst = tdist.simulate_dist(pack_state(ts), tc, tsg, tm, 10, growth=tgp)
    assert t_state_digest(unpack_state(pfin)) == t_state_digest(tfin) and t_stats_digest(pst) == t_stats_digest(tst)


def test_run_until_coverage_grows_as_jax():
    tc, ts, tgp = _grown(**GROWN_RUNS["to_coverage"][0])
    tf = te.run_until_coverage(ts, tc, 0.99, 40, growth=tgp)
    assert t_state_digest(tf) == pinned("growth_runs", "to_coverage")["state_digest"] and int(tf.exists.sum()) > N0


# ------------------------------------------------------------ checkpoints

def test_mid_growth_checkpoint_resumes_bit_exactly_across_packages(tmp_path):
    """A mid-growth state saved by either package loads in the other with
    its registry planes and finishes the schedule on the same bits."""
    from tpu_gossip.core.state import load_swarm as j_load
    from tpu_gossip.core.state import save_swarm as j_save

    from tpu_gossip_torch.core.state import load_swarm as t_load
    from tpu_gossip_torch.core.state import save_swarm as t_save

    (jc, js, jgp), (tc, ts, tgp) = _grown_jax(), _grown()
    jmid, _ = je.simulate(js, jc, 4, None, "fused", None, jgp)
    tmid, _ = te.simulate(ts, tc, 4, growth=tgp)
    assert N0 < int(tmid.exists.sum()) < CAP
    j_save(tmp_path / "j.npz", jmid)
    t_save(tmp_path / "t.npz", tmid)
    from_jax, from_port = t_load(tmp_path / "j.npz", device="cpu"), j_load(tmp_path / "t.npz")
    for f in ("join_round", "admitted_by", "degree_credit"):
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(), np.asarray(getattr(jmid, f)), err_msg=f)
    jfin, _ = je.simulate(from_port, jc, 8, None, "fused", None, jgp)
    tfin, _ = te.simulate(from_jax, tc, 8, growth=tgp)
    assert t_state_digest(tfin) == j_state_digest(jfin) and int(tfin.exists.sum()) == CAP


@pytest.mark.parametrize("form", ["pre_growth", "v1"])
def test_pre_growth_checkpoint_loads_with_registry_zeroed(tmp_path, form):
    """A checkpoint from before the registry planes (named, or the round-1
    positional layout) loads as JAX loads it: every existing row a
    bootstrap member, nobody admitted by anyone, no credit."""
    from tpu_gossip.core.state import load_swarm as j_load
    from tpu_gossip.core.state import save_swarm as j_save

    from tpu_gossip_torch.core.state import load_swarm as t_load

    g = _seed_graph(32)
    cfg = JConfig(n_peers=32, msg_slots=4)
    st = j_init(g, cfg, origins=[1])
    if form == "pre_growth":
        mid, _ = je.simulate(st, cfg, 3)
        j_save(tmp_path / "new.npz", mid)
        data = dict(np.load(tmp_path / "new.npz"))
        for k in ("field_join_round", "field_admitted_by", "field_degree_credit"):
            del data[k]
        np.savez(tmp_path / "old.npz", **data)
    else:
        from tests.unit.test_state import save_v1

        save_v1(st, tmp_path / "old.npz", per_peer_sir=True)
    want, got = j_load(tmp_path / "old.npz"), t_load(tmp_path / "old.npz", device="cpu")
    ex = got.exists.numpy()
    assert (got.join_round.numpy()[ex] == 0).all() and (got.join_round.numpy()[~ex] == -1).all()
    assert (got.admitted_by.numpy() == -1).all() and not got.degree_credit.any()
    assert t_state_digest(got) == j_state_digest(want)
    fin, _ = te.simulate(got, TConfig(n_peers=32, msg_slots=4), 3)
    assert int(fin.round) == int(want.round) + 3


# ------------------------------------------------------------ conformance: the sim half of the bootstrap

def test_sim_growth_degrees_equal_jax():
    """tests/conformance/test_growth_bootstrap.py::sim_growth_degrees: a
    K4 clique grown to 24 peers one admission a round; the port's degree
    sequence is JAX's, for each seed of its sweep."""
    from tests.conformance.test_growth_bootstrap import ATTACH as B_ATTACH
    from tests.conformance.test_growth_bootstrap import N_SWARM, sim_growth_degrees

    for seed in range(3):
        n0 = B_ATTACH + 1
        graph, exists = tg.pad_graph_for_growth(_seed_graph(n0, m=B_ATTACH, seed=seed), N_SWARM)
        cfg = TConfig(n_peers=N_SWARM, msg_slots=1, fanout=2, mode="push", rewire_slots=B_ATTACH)
        st = t_init(graph, cfg, origins=[0], exists=torch.from_numpy(exists), key=prng.key(seed, "cpu"), device="cpu")
        gp = tg.compile_growth(n_initial=n0, target=N_SWARM, n_slots=N_SWARM, joins_per_round=1, attach_m=B_ATTACH,
                               device="cpu")
        fin, _ = te.simulate(st, cfg, N_SWARM - n0 + 1, growth=gp)
        assert int(fin.exists.sum()) == N_SWARM
        deg = tg.realized_degrees(fin.row_ptr, fin.exists, fin.rewired, fin.rewire_targets, fin.degree_credit)
        np.testing.assert_array_equal(deg.numpy()[:N_SWARM], sim_growth_degrees(N_SWARM, seed))


def test_growth_run_pins_are_current():
    """One growing run's JAX half, recomputed in a child process, equals its pin."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    got = jax_in_child("tests.jax_pins", "compute", "growth_runs", ["storm"])
    assert got == {"storm": pinned("growth_runs", "storm")}
