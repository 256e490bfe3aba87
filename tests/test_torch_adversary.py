"""The quorum detector and the Byzantine adversaries
(``tpu_gossip_torch/kernels/liveness.py`` and the flood replay of
``faults/inject.py``) against the JAX package's, bit for bit on the CPU:
the packed suspicion plane and its caps, ``QuorumSpec``'s refusals,
``forge_heartbeats`` and ``quorum_liveness`` on seeded planes with open
suspicions (window expiry, refutation, strike and quarantine crossings),
the flood replay inside ``faulted_dissemination``, ``quorum_k=1`` without
adversaries against the direct detector (the whole state), the cells of
``tests/sim/test_adversary.py`` (each run equal to JAX's through the
digests, and the cell's own law holding on the port's run), checkpoints
cut mid-suspicion, and the siege on the bucketed engine at S = 1 and 3
with its packed twins."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import SwarmConfig as JConfig
from tpu_gossip import build_csr, preferential_attachment
from tpu_gossip import faults as jf
from tpu_gossip.core.state import clone_state as j_clone
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.kernels import liveness as jl
from tpu_gossip.sim import metrics as JM
from tpu_gossip.sim.engine import simulate as j_sim
from tpu_gossip_torch import convert
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch import faults as tf
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.kernels import liveness as tl
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.sim.engine import simulate as t_sim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_ckpt import _jleaves
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

N = 200


@pytest.fixture(scope="module")
def graph():
    return build_csr(N, preferential_attachment(N, m=3, use_native=False))


def _cfgs(**kw):
    kw = {**dict(n_peers=N, msg_slots=8, fanout=3, mode="push"), **kw}
    return JConfig(**kw), TConfig(**kw)


def _swarms(g, seed=0, silent=0, **kw):
    jc, tc = _cfgs(**kw)
    js = j_init(g, jc, origins=[0], key=jax.random.key(seed))
    ts = t_init(g, tc, origins=[0], key=prng.key(seed, "cpu"), device="cpu")
    if silent:
        ids = np.random.default_rng(7).choice(N, size=silent, replace=False)
        js.silent = js.silent.at[jnp.asarray(ids)].set(True)
        ts.silent[torch.as_tensor(ids)] = True
    return (jc, js), (tc, ts)


def _compile(d, total_rounds, n=N, n_slots=None, **kw):
    kw = dict(n_peers=n, n_slots=n if n_slots is None else n_slots, total_rounds=total_rounds, **kw)
    return (jf.compile_scenario(jf.scenario_from_dict(d), **kw),
            tf.compile_scenario(tf.scenario_from_dict(d), device="cpu", **kw))


def _adv(rounds, accusers=0.05, forgers=0.0, floods=0.0, **extra):
    phase = {"name": "adv", "start": 0, "end": rounds, **extra}
    for key, frac, seed in (("accusers", accusers, 3), ("forgers", forgers, 4), ("floods", floods, 5)):
        if frac:
            phase[key] = {"frac": frac, "seed": seed}
    return {"name": "adv", "phases": [phase]}


def _quorums(quorum_k=1, **kw):
    return jl.compile_quorum(quorum_k, **kw), tl.compile_quorum(quorum_k, **kw)


def _run_both(g, rounds, d=None, q=None, silent=0, seed=0, **kw):
    """The same run in both packages: digests, coverage and every stats
    column equal; returns the port's final state and stats."""
    (jc, js), (tc, ts) = _swarms(g, seed, silent, **kw)
    jsc, tsc = _compile(d, rounds) if d is not None else (None, None)
    jq, tq = _quorums(**q) if q is not None else (None, None)
    jfin, jst = j_sim(js, jc, rounds, None, "fused", jsc, None, None, None, None, jq)
    tfin, tst = t_sim(ts, tc, rounds, scenario=tsc, liveness=tq)
    assert t_state_digest(tfin) == j_state_digest(jfin)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    for f in ("evictions_new", "false_evictions", "n_quarantined", "dead_undeclared", "adv_accusations",
              "adv_forged", "msgs_sent"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
    assert TM.liveness_report(tst) == JM.liveness_report(jst)
    return tfin, tst


# ---------------------------------------------------------------- packing


def test_suspicion_packing_equals_jax_and_caps():
    assert (tl.SUSPECT_VOTE_CAP, tl.SUSPECT_STRIKE_CAP) == (jl.SUSPECT_VOTE_CAP, jl.SUSPECT_STRIKE_CAP)
    rng = np.random.default_rng(0)
    votes = np.concatenate([[0, 1, 17, tl.SUSPECT_VOTE_CAP], rng.integers(0, 256, 200)]).astype(np.int32)
    strikes = np.concatenate([[0, 3, 99, tl.SUSPECT_STRIKE_CAP], rng.integers(0, 128, 200)]).astype(np.int32)
    got = tl.pack_suspicion(torch.from_numpy(votes), torch.from_numpy(strikes))
    want = jl.pack_suspicion(jnp.asarray(votes), jnp.asarray(strikes))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[3]) == 2**15 - 1  # the largest packed value is int16's ceiling
    for g, w, src in zip(tl.unpack_suspicion(got), jl.unpack_suspicion(want), (votes, strikes)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), src)


SPEC_REFUSALS = [dict(quorum_k=0), dict(quorum_k=-3), dict(quorum_k=256), dict(window=0), dict(window=-1),
                 dict(budget=128), dict(budget=-1)]


@pytest.mark.parametrize("kw", SPEC_REFUSALS, ids=lambda kw: "_".join(f"{k}{v}" for k, v in kw.items()))
def test_quorum_spec_refusals_say_what_jax_says(kw):
    with pytest.raises(ValueError) as want:
        jl.QuorumSpec(**kw)
    with pytest.raises(ValueError) as got:
        tl.QuorumSpec(**kw)
    assert str(got.value) == str(want.value)
    assert tl.compile_quorum(3, window=6, budget=0) == tl.QuorumSpec(3, 6, 0)


# -------------------------------------------- the detector on seeded planes


def _planes(seed, rnd, n=N, budget=3):
    """Seeded planes with open suspicions: heartbeats up to 12 rounds old,
    a third of the rows suspected for up to 8 rounds (some past a 4-round
    window), votes and strikes (some one short of ``budget``), silent,
    dead, declared, quarantined and absent rows."""
    rng = np.random.default_rng(seed)
    last_hb = (rnd - rng.integers(0, 13, n)).astype(np.int16)
    suspect_round = np.where(rng.random(n) < 0.35, rnd - rng.integers(0, 9, n), -1).astype(np.int16)
    votes = np.where(suspect_round >= 0, rng.integers(0, 4, n), 0)
    strikes = np.where(rng.random(n) < 0.3, rng.integers(max(budget - 1, 0), budget + 1, n), 0)
    return {
        "last_hb": last_hb,
        "alive": rng.random(n) < 0.85,
        "silent": rng.random(n) < 0.2,
        "declared_dead": rng.random(n) < 0.1,
        "suspect_round": suspect_round,
        "suspect_mark": (votes + 256 * strikes).astype(np.int16),
        "quarantine": rng.random(n) < 0.05,
        "exists": rng.random(n) < 0.97,
    }


PLANE_FIELDS = ("last_hb", "alive", "silent", "declared_dead", "suspect_round", "suspect_mark", "quarantine",
                "exists")
LIVENESS_CASES = {  # name: (round, QuorumSpec kwargs, accusers' share or None)
    "sweep_k1_no_adversary": (14, dict(quorum_k=1), None),
    "sweep_k3_accusers": (14, dict(quorum_k=3, window=4, budget=3), 0.3),
    "off_sweep_k2_accusers": (15, dict(quorum_k=2, window=4, budget=2), 0.5),
    "sweep_k2_no_quarantine": (16, dict(quorum_k=2, window=6, budget=0), 0.4),
    "sweep_window1_budget1": (20, dict(quorum_k=5, window=1, budget=1), 0.6),
}


@pytest.mark.parametrize("name", list(LIVENESS_CASES))
def test_quorum_liveness_equals_jax_on_seeded_planes(name):
    rnd, qkw, accuse = LIVENESS_CASES[name]
    p = _planes(len(name) + rnd, rnd, budget=qkw.get("budget", 3))
    accuser_ok = None if accuse is None else np.random.default_rng(9).random(N) < accuse
    jargs = [jnp.asarray(p[f]) for f in PLANE_FIELDS]
    targs = [torch.from_numpy(p[f]) for f in PLANE_FIELDS]
    want = jl.quorum_liveness(jl.compile_quorum(**qkw), jargs[0], *jargs[1:7], jargs[7], jnp.int32(rnd), 6, 2,
                              k_accuse=jax.random.key(5),
                              accuser_ok=None if accuser_ok is None else jnp.asarray(accuser_ok))
    got = tl.quorum_liveness(tl.compile_quorum(**qkw), targs[0], *targs[1:7], targs[7],
                             torch.tensor(rnd, dtype=torch.int32), 6, 2, k_accuse=prng.key(5, "cpu"),
                             accuser_ok=None if accuser_ok is None else torch.from_numpy(accuser_ok))
    assert set(got) == set(want)
    for k in want:
        assert getattr(got[k], "dtype", None) == {"last_hb": torch.int16, "suspect_round": torch.int16,
                                                  "suspect_mark": torch.int16}.get(k, got[k].dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the case exercises what it names
    was = p["suspect_round"] >= 0
    assert (was & (got["suspect_round"].numpy() < 0)).any()  # some suspicion cleared or declared
    if rnd % 2 == 0:
        assert int(got["evictions_new"]) > 0
    if accuse is not None and qkw["budget"] > 0:
        assert int(got["adv_accusations"]) > 0 and got["newly_quarantined"].any()


@pytest.mark.parametrize("fanout_now", [0, 1, 3])
def test_forge_heartbeats_equals_jax(fanout_now):
    p = _planes(3, 21)
    forger_ok = np.random.default_rng(4).random(N) < 0.3
    want = jl.forge_heartbeats(jnp.asarray(p["last_hb"]), jnp.asarray(p["suspect_round"]), jnp.asarray(forger_ok),
                               jnp.int32(21), jax.random.key(8), jnp.int32(fanout_now), 3)
    got = tl.forge_heartbeats(torch.from_numpy(p["last_hb"]), torch.from_numpy(p["suspect_round"]),
                              torch.from_numpy(forger_ok), torch.tensor(21, dtype=torch.int32), prng.key(8, "cpu"),
                              torch.tensor(fanout_now, dtype=torch.int32), 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int16 and int(got[1]) == int(want[1]) == fanout_now * int(forger_ok.sum())
    refreshed = got[0].numpy() != p["last_hb"]
    assert refreshed.any() == (fanout_now > 0) and not refreshed[p["suspect_round"] >= 0].any()


@pytest.mark.parametrize("partition", [False, True])
def test_flood_replay_in_the_head_equals_jax(partition):
    """``faulted_dissemination`` with flooders (and a blackout, with or
    without a partition) around a deterministic delivery core: incoming,
    bill and effective transmit equal JAX's, and the replay lands."""
    rng = np.random.default_rng(6)
    planes = {k: rng.random((N, 8)) < q for k, q in
              (("transmit", 0.3), ("transmitter", 0.8), ("receptive", 0.8), ("held", 0.0), ("seen", 0.5))}
    phase = {"start": 0, "end": 3, "floods": {"frac": 0.1, "seed": 5}, "flood_fanout": 3,
             "blackout": {"ids": [1, 2, 3, 40]}}
    if partition:
        phase["partition"] = "half"
    jsc, tsc = _compile({"phases": [phase]}, 8)
    flood_ok = np.random.default_rng(1).random(N) < 0.9

    def j_deliver(tx, tr, rc, kp, kq):
        return jnp.roll(tx & tr, 1, axis=0) & rc, jnp.sum(tx, dtype=jnp.int32)

    def t_deliver(tx, tr, rc, kp, kq):
        return torch.roll(tx & tr, 1, dims=0) & rc, tx.sum(dtype=torch.int64).to(torch.int32)

    names = ("transmit", "transmitter", "receptive", "held", "seen")
    jrf, trf = jsc.at_round(jnp.int32(2)), tsc.at_round(2)
    want = jf.faulted_dissemination(jsc, jrf, j_deliver, *(jnp.asarray(planes[k]) for k in names),
                                    *[jax.random.key(i) for i in (1, 2, 3)],
                                    jnp.asarray(flood_ok) & jrf.flooder, jax.random.key(4))
    got = tf.faulted_dissemination(tsc, trf, t_deliver, *(torch.from_numpy(planes[k]) for k in names),
                                   *[prng.key(i, "cpu") for i in (1, 2, 3)],
                                   torch.from_numpy(flood_ok) & trf.flooder, prng.key(4, "cpu"))
    for what, g, w in zip(("incoming", "msgs", "tx_eff"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    plain = torch.roll(torch.from_numpy(planes["transmit"] & planes["transmitter"]), 1, dims=0)
    assert int(got[1]) > int(planes["transmit"].sum()) and bool((got[0] & ~plain).any())


# ------------------------------------------------- the cells of test_adversary


def test_quorum_k1_no_adversary_gives_the_direct_detectors_whole_state(graph):
    """quorum_k=1 with no adversary: the whole state (the suspicion planes
    included) equals the direct detector's, and both equal JAX's."""
    fin_q, st_q = _run_both(graph, 12, q={}, silent=20, mode="push_pull")
    fin_d, st_d = _run_both(graph, 12, silent=20, mode="push_pull")
    for f in dataclasses.fields(fin_d):
        assert torch.equal(getattr(fin_q, f.name), getattr(fin_d, f.name)), f.name
    np.testing.assert_array_equal(st_q.n_declared_dead.numpy(), st_d.n_declared_dead.numpy())
    assert int(st_d.n_declared_dead[-1]) == 20


@pytest.mark.parametrize("k", [2, 5, 50])
def test_quorum_detection_latency_equals_direct_detector(graph, k):
    _, direct = _run_both(graph, 12, silent=30)
    _, hardened = _run_both(graph, 12, q=dict(quorum_k=k), silent=30)
    np.testing.assert_array_equal(hardened.n_declared_dead.numpy(), direct.n_declared_dead.numpy())


def test_unhardened_round_carries_suspicion_planes_untouched(graph):
    fin, _ = _run_both(graph, 8, silent=10)
    assert int(fin.suspect_round.max()) == -1 and int(fin.suspect_mark.max()) == 0
    assert not bool(fin.quarantine.any())


def test_adversary_scenario_requires_defense(graph):
    (_, _), (tc, ts) = _swarms(graph)
    _, tsc = _compile(_adv(8), 8)
    with pytest.raises(ValueError, match="quorum"):
        t_sim(ts, tc, 8, scenario=tsc)
    with pytest.raises(ValueError, match="quorum"):
        t_sim(pack_state(ts), tc, 8, scenario=tsc)


def test_single_accuser_evicts_healthy_peers_at_k1(graph):
    _, stats = _run_both(graph, 10, _adv(10, accusers=0.05), q={})
    lv = TM.liveness_report(stats)
    assert lv["false_evictions"] > 20 and lv["eviction_precision"] < 0.5 and lv["quarantined"] == 0


def test_quorum_resists_accusers_and_quarantines_them(graph):
    _, stats = _run_both(graph, 20, _adv(20, accusers=0.05), q=dict(quorum_k=3, window=4, budget=3))
    lv = TM.liveness_report(stats)
    assert lv["false_evictions"] == 0 and lv["quarantined"] == 10
    acc = stats.adv_accusations.numpy()
    assert acc[:3].sum() > 0 and acc[-5:].sum() == 0
    assert int(stats.n_alive[-1]) == N


def test_lone_repeat_accuser_never_meets_quorum_2(graph):
    d = {"name": "lone", "phases": [{"name": "adv", "start": 0, "end": 40, "accusers": {"ids": [7]}}]}
    _, stats = _run_both(graph, 40, d, q=dict(quorum_k=2, window=6, budget=0))
    assert int(stats.adv_accusations.sum()) > 30
    assert int(stats.false_evictions.sum()) == 0 and int(stats.evictions_new.sum()) == 0


def test_blacked_out_adversaries_emit_nothing(graph):
    d = {"name": "dark-adv", "phases": [{"name": "adv", "start": 0, "end": 10, "accusers": {"ids": [3, 4]},
                                         "forgers": {"ids": [5]}, "blackout": {"ids": [3, 4, 5]}}]}
    _, stats = _run_both(graph, 10, d, q={})
    assert int(stats.adv_accusations.sum()) == 0 and int(stats.adv_forged.sum()) == 0


def test_quarantine_releases_rewire_credit_book_balance(graph):
    fin, _ = _run_both(graph, 16, _adv(16, accusers=0.08), q=dict(quorum_k=3, window=4, budget=2), fanout=2,
                       churn_leave_prob=0.05, churn_join_prob=0.3, rewire_slots=2)
    assert bool(fin.quarantine.any()) and not bool((fin.quarantine & fin.rewired).any())
    stored = int((fin.rewire_targets[fin.rewired] >= 0).sum())
    assert int(fin.degree_credit.sum()) == stored


def test_defended_churn_compact_side_paths(graph):
    """The defended churn stage's compact form (``rewire_compact_cap``):
    quarantined rejoiners take no fresh edges."""
    fin, _ = _run_both(graph, 16, _adv(16, accusers=0.08), q=dict(quorum_k=3, window=4, budget=2), fanout=2,
                       churn_leave_prob=0.05, churn_join_prob=0.3, rewire_slots=2, rewire_compact_cap=16)
    assert bool(fin.quarantine.any()) and not bool((fin.quarantine & fin.rewired).any())


def test_forgery_stalls_detection_entry_but_not_active_suspicion(graph):
    base = _adv(30, accusers=0.0, loss=0.01)
    forged = _adv(30, accusers=0.0, forgers=0.10, forge_fanout=4)
    _, s0 = _run_both(graph, 30, base, q=dict(quorum_k=3), silent=30)
    _, s1 = _run_both(graph, 30, forged, q=dict(quorum_k=3), silent=30)
    dead0, dead1 = s0.n_declared_dead.numpy(), s1.n_declared_dead.numpy()
    assert dead0[-1] == 30 and int(s1.adv_forged.sum()) > 0
    assert dead1.sum() < 0.5 * dead0.sum() and 0 < dead1[-1] < 30 and (np.diff(dead1) >= 0).all()


def test_flood_replay_bills_wire_and_duplicates(graph):
    _, s0 = _run_both(graph, 12, _adv(12, accusers=0.0, loss=0.01), q=dict(quorum_k=3))
    _, s1 = _run_both(graph, 12, _adv(12, accusers=0.0, floods=0.10, flood_fanout=4), q=dict(quorum_k=3))
    assert int(s1.msgs_sent.sum()) > int(s0.msgs_sent.sum()) + 300
    assert float(s1.coverage[-1]) >= 0.95


# ------------------------------------------------- checkpoints mid-suspicion


def test_suspicion_cursor_resumes_mid_window_across_packages(graph, tmp_path):
    """A state cut mid-suspicion (votes pending, strikes accrued, rows
    quarantined) saved with ``save_swarm``, or carried across from JAX,
    resumes onto the uninterrupted run; packed, too."""
    from tpu_gossip_torch.core.state import load_swarm, save_swarm

    (jc, js), (tc, ts) = _swarms(graph, silent=10)
    jsc, tsc = _compile(_adv(14, accusers=0.06, forgers=0.03, floods=0.03), 14)
    jq, tq = _quorums(5, window=6, budget=4)
    jmid, _ = j_sim(js, jc, 7, None, "fused", jsc, None, None, None, None, jq)
    tmid, _ = t_sim(ts, tc, 7, scenario=tsc, liveness=tq)
    assert t_state_digest(tmid) == j_state_digest(jmid)
    assert bool((tmid.suspect_round >= 0).any()) and bool((tmid.suspect_mark != 0).any())
    jfin, _ = j_sim(j_clone(jmid), jc, 7, None, "fused", jsc, None, None, None, None, jq)
    save_swarm(tmp_path / "mid.npz", tmid)
    carried = convert.state_from_jax(_jleaves(jmid), device="cpu")
    for start in (tmid, load_swarm(tmp_path / "mid.npz", device="cpu"), carried):
        fin, _ = t_sim(start, tc, 7, scenario=tsc, liveness=tq)
        assert t_state_digest(fin) == j_state_digest(jfin)
    pfin, _ = t_sim(pack_state(carried), tc, 7, scenario=tsc, liveness=tq)
    assert t_state_digest(unpack_state(pfin)) == j_state_digest(jfin)


@pytest.mark.parametrize("dropped", [("suspect_round", "suspect_mark", "quarantine"),
                                     ("suspect_round", "suspect_mark")])
def test_legacy_files_without_suspicion_planes_load_as_jax_loads_them(graph, tmp_path, dropped):
    """A named file from before the suspicion planes loads with them
    zeroed; one carrying some keeps those (a stored quarantine verdict is
    never overwritten)."""
    from tpu_gossip.core.state import load_swarm as j_load
    from tpu_gossip_torch.core.state import load_swarm

    (_, js), _ = _swarms(graph)
    js.quarantine = js.quarantine.at[3].set(True)
    arrays = {("prngkey_rng" if k == "rng" else f"field_{k}"): v for k, v in _jleaves(js).items() if k not in dropped}
    p = tmp_path / "old.npz"
    np.savez(p, **arrays)
    got, want = load_swarm(p, device="cpu"), j_load(p)
    assert t_state_digest(got) == j_state_digest(want)
    assert bool(got.quarantine[3]) == ("quarantine" not in dropped)
    assert int(got.suspect_round.max()) == -1 and int(got.suspect_mark.max()) == 0


# --------------------------------------------- the siege on the bucketed engine

SIEGE = {"name": "siege", "phases": [
    {"name": "siege", "start": 1, "end": 9, "blackout": {"frac": 0.1, "seed": 2}, "accusers": {"frac": 0.05, "seed": 3},
     "forgers": {"frac": 0.03, "seed": 4}, "floods": {"frac": 0.05, "seed": 5}, "forge_fanout": 2, "flood_fanout": 3},
    {"name": "aftermath", "start": 9, "end": 12, "loss": 0.1},
]}


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_siege_equals_jax_mesh_local_and_packed_twin(graph, s):
    """push_pull on the bucketed engine under the siege at quorum 3, K6
    receive: equal to the JAX mesh's run; the scatter receive and the
    packed twin equal to it."""
    from tpu_gossip.dist import build_shard_plans as j_plans
    from tpu_gossip.dist import simulate_dist as j_sim_dist
    from tests.test_torch_dist import _build

    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, s, origins=(0, 5), mode="push_pull", fanout=1, m=8)
    _, _, position = tdist.partition_graph(graph, s, seed=1, device="cpu")
    jsc, tsc = _compile(SIEGE, 12, n_slots=tsg.n_pad, node_map=lambda ids: position[np.asarray(ids)],
                        shard_ranges=tdist.shard_ranges(s, tsg.per_shard), n_shards=s)
    jq, tq = _quorums(3, window=4, budget=2)
    jfin, jst = j_sim_dist(js, jc, jsg, jm, 12, j_plans(jsg), jsc, liveness=jq)
    plans = tdist.build_shard_plans(tsg)
    tfin, tst = tdist.simulate_dist(ts, tc, tsg, tm, 12, plans, scenario=tsc, liveness=tq)
    assert t_state_digest(tfin) == j_state_digest(jfin) and t_stats_digest(tst) == j_stats_digest(jst)
    assert int(tst.adv_accusations.sum()) > 0 and int(tst.adv_forged.sum()) > 0
    sfin, sst = tdist.simulate_dist(ts, tc, tsg, tm, 12, None, scenario=tsc, liveness=tq)
    pfin, pst = tdist.simulate_dist(pack_state(ts), tc, tsg, tm, 12, plans, scenario=tsc, liveness=tq)
    for fin, st in ((sfin, sst), (unpack_state(pfin), pst)):
        assert t_state_digest(fin) == t_state_digest(tfin) and t_stats_digest(st) == t_stats_digest(tst)


@pytest.mark.parametrize("mode", ["push", "push_pull", "flood"])
def test_packed_siege_equals_unpacked_and_jax(graph, mode):
    kw = dict(mode=mode) if mode == "flood" else dict(mode=mode, fanout=2)
    (jc, js), (tc, ts) = _swarms(graph, **kw)
    jsc, tsc = _compile(SIEGE, 12)
    jq, tq = _quorums(3, window=4, budget=2)
    jfin, jst = j_sim(js, jc, 12, None, "fused", jsc, None, None, None, None, jq)
    ufin, ust = t_sim(ts, tc, 12, scenario=tsc, liveness=tq)
    pfin, pst = t_sim(pack_state(ts), tc, 12, scenario=tsc, liveness=tq)
    assert t_state_digest(unpack_state(pfin)) == t_state_digest(ufin) == j_state_digest(jfin)
    assert t_stats_digest(pst) == t_stats_digest(ust) == j_stats_digest(jst)
