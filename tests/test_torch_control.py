"""The adaptive controller's plan and round hooks (``tpu_gossip_torch/
control/``) against the JAX package's on the CPU: ``compile_control``'s
tables, stress rung, start level and needy default over a grid of
fanouts, bounds, refresh cadences and TTLs, every ``ControlError`` in
JAX's words; ``control_round`` and ``apply_control`` on seeded planes
(a fresh cursor, a foreign cursor clipped into the table, the stress bit,
the knee gate, the needy rows, the fault head's loss, a stream slot's TTL
lag, the PeerSwap refresh with its credit book balanced), each output
equal to JAX's; ``reliability_report`` on the same stats; and the
analogues of ``tests/sim/test_control.py``'s behaviour cells (the
controller widens under loss, ``control=None`` carries the cursor, the
cursor survives a checkpoint)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import control as jctl
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import clone_state as j_clone
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.core.topology import build_csr, preferential_attachment
from tpu_gossip.faults import compile_scenario as j_compile_scenario
from tpu_gossip.faults import scenario_from_dict as j_scenario_from_dict
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip.sim import metrics as JM
from tpu_gossip.traffic import compile_stream as j_compile_stream
from tpu_gossip_torch import control as tctl
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.core.state import load_swarm, save_swarm
from tpu_gossip_torch.faults import compile_scenario as t_compile_scenario
from tpu_gossip_torch.faults import scenario_from_dict as t_scenario_from_dict
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.traffic import compile_stream as t_compile_stream
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

N = 300


def seed_graph(n=N, seed=0):
    return build_csr(n, preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(seed)))


def swarms(n=N, seed=0, **cfg_kw):
    """(jax (cfg, state), port (cfg, state)) of one push_pull swarm at
    fanout 3 and 4 slots, seeded at peer 0."""
    g = seed_graph(n)
    kw = dict(n_peers=n, msg_slots=cfg_kw.pop("msg_slots", 4), fanout=3, mode=cfg_kw.pop("mode", "push_pull"),
              **cfg_kw)
    jc, tc = JConfig(**kw), TConfig(**kw)
    return ((jc, j_init(g, jc, origins=[0], key=jax.random.key(seed))),
            (tc, t_init(g, tc, origins=[0], key=prng.key(seed, "cpu"), device="cpu")))


def controls(**kw):
    return jctl.compile_control(**kw), tctl.compile_control(**kw, device="cpu")


# ------------------------------------------------------------------ compile

GRID = [dict(fanout=f, lo=lo, hi=hi, refresh_every=r, ttl=t)
        for f in (1, 2, 3, 4) for lo, hi in ((None, None), (1, 2 * f), (f, f), (1, f), (f, f + 3))
        for r, t in ((0, 0), (4, 15))]


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "f{fanout}_lo{lo}_hi{hi}_r{refresh_every}".format(**kw))
def test_compile_control_tables_equal_jax(kw):
    j, t = controls(target_ratio=0.9, **kw)
    np.testing.assert_array_equal(t.fanout_table.numpy(), np.asarray(j.fanout_table))
    np.testing.assert_array_equal(t.pull_table.numpy(), np.asarray(j.pull_table))
    assert t.fanout_table.dtype == torch.int32 and t.pull_table.dtype == torch.bool
    for name in ("target_ratio", "sat_dup", "pull_knee"):
        got = getattr(t, name)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy().tobytes() == np.asarray(getattr(j, name)).tobytes(), name
    for name in ("lo", "hi", "base", "levels", "start", "refresh_every", "ttl", "pull_needy", "base_idx"):
        assert getattr(t, name) == getattr(j, name), name


BAD = [dict(target_ratio=0.0), dict(target_ratio=1.5), dict(sat_dup=0.0), dict(pull_knee=1.2), dict(lo=0, hi=4),
       dict(lo=4, hi=2), dict(fanout=5, lo=1, hi=4), dict(lo=4, hi=6), dict(refresh_every=-1), dict(ttl=-2)]


@pytest.mark.parametrize("bad", BAD, ids=lambda b: "_".join(f"{k}{v}" for k, v in b.items()))
def test_compile_control_refusals_in_jax_words(bad):
    kw = {**dict(target_ratio=0.9, fanout=3), **bad}
    with pytest.raises(jctl.ControlError) as jerr:
        jctl.compile_control(**kw)
    with pytest.raises(tctl.ControlError) as terr:
        tctl.compile_control(**kw, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_compile_control_defaults_pin_the_stress_rung_and_needy_gate():
    _, t = controls(target_ratio=0.9, fanout=3, lo=1, hi=6)
    assert t.levels == 7 and t.start == 5 and t.pull_needy
    assert t.fanout_table.tolist() == [1, 2, 3, 4, 5, 6, 6]
    assert t.pull_table.tolist() == [True, True, True, False, False, False, True]
    _, z = controls(target_ratio=0.9, fanout=3, lo=3, hi=3)
    assert z.levels == 1 and z.pull_table.tolist() == [True] and not z.pull_needy


# ------------------------------------------------------------ round hooks

def _planes(seed, n=64, m=8):
    rng = np.random.default_rng(seed)
    alive = rng.random(n) < 0.9
    planes = dict(
        alive=alive, declared_dead=(rng.random(n) < 0.05) & alive, exists=rng.random(n) < 0.97,
        seen=rng.random((n, m)) < 0.6, seen_prev=rng.random((n, m)) < 0.4, incoming=rng.random((n, m)) < 0.5,
        slot_lease=np.where(rng.random(m) < 0.7, rng.integers(0, 12, m), -1).astype(np.int16),
        rewired=rng.random(n) < 0.3, degree_credit=np.zeros(n, np.int32),
    )
    planes["seen_prev"] &= planes["seen"]
    return planes


def _pair(planes):
    return (types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in planes.items()}),
            types.SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in planes.items()}))


ROUND_CASES = {  # name: (control kwargs, cursor, planes seed)
    "fresh_cursor": (dict(lo=1, hi=6), -1, 0),
    "foreign_cursor_clipped": (dict(lo=1, hi=6), 40, 1),
    "negative_cursor": (dict(lo=1, hi=4), -7, 2),
    "stress_bit": (dict(lo=1, hi=6), 7 + 2, 3),
    "knee_gate": (dict(lo=1, hi=6, pull_knee=0.3), 4, 4),
    "knee_closed": (dict(lo=1, hi=6, pull_knee=0.95), 4, 5),
    "zero_adjustment": (dict(lo=3, hi=3), -1, 6),
    "needy_forced_off": (dict(lo=1, hi=6, pull_needy=False), 2, 7),
}


@pytest.mark.parametrize("name", ROUND_CASES)
@pytest.mark.parametrize("want_needy", [True, False])
def test_control_round_equals_jax(name, want_needy):
    kw, cursor, seed = ROUND_CASES[name]
    j, t = controls(target_ratio=0.9, fanout=3, **kw)
    planes = _planes(seed)
    planes["control_lvl"] = np.int32(cursor)
    js, ts = _pair(planes)
    jr, tr = jctl.control_round(j, js, want_needy), tctl.control_round(t, ts, want_needy)
    for field in ("m_eff", "pull_on", "lvl"):
        got, want = getattr(tr, field), np.asarray(getattr(jr, field))
        assert got.dim() == 0 and got.numpy() == want and got.numpy().dtype == want.dtype, field
    assert tr.width == jr.width == t.hi
    assert (tr.needy is None) == (jr.needy is None)
    if jr.needy is not None:
        np.testing.assert_array_equal(tr.needy.numpy(), np.asarray(jr.needy))


APPLY_CASES = {  # name: (control kwargs, cursor, fstats (dropped, delivered) or None, round, rewire slots)
    "saturated_shrink": (dict(lo=1, hi=6, sat_dup=0.1), 5, None, 9, 0),
    "loss_widens": (dict(lo=1, hi=6), 3, (900, 1000), 9, 0),
    "loss_under_tolerance": (dict(lo=1, hi=6), 3, (50, 10000), 9, 0),
    "ttl_lag_widens": (dict(lo=1, hi=6, ttl=8), 2, None, 11, 0),
    "ttl_lag_at_the_rung": (dict(lo=1, hi=6, ttl=8), 6, None, 11, 0),
    "refresh_due": (dict(lo=1, hi=4, refresh_every=3), 2, None, 12, 3),
    "refresh_off_cadence": (dict(lo=1, hi=4, refresh_every=3), 2, None, 13, 3),
    "zero_adjustment": (dict(lo=3, hi=3), -1, (10, 10), 4, 0),
}


@pytest.mark.parametrize("name", APPLY_CASES)
def test_apply_control_equals_jax(name):
    kw, cursor, fst, rnd, slots = APPLY_CASES[name]
    j, t = controls(target_ratio=0.9, fanout=3, **kw)
    n, seed = 64, sorted(APPLY_CASES).index(name)
    g = seed_graph(n, seed)
    planes = _planes(seed, n=n)
    planes["control_lvl"] = np.int32(cursor)
    rt = np.random.default_rng(seed + 50).integers(-1, n, (n, max(slots, 1))).astype(np.int32)
    rt[~planes["rewired"]] = -1
    planes["rewire_targets"] = rt
    # the credit book: each rewired row's stored fresh targets
    planes["degree_credit"] = np.bincount(rt[planes["rewired"]][rt[planes["rewired"]] >= 0],
                                          minlength=n).astype(np.int32)
    js, ts = _pair(planes)
    jr, tr = jctl.control_round(j, js, True), tctl.control_round(t, ts, True)
    common = ("incoming", "seen_prev", "seen", "alive", "declared_dead", "exists", "rewired", "rewire_targets",
              "degree_credit", "slot_lease")
    jf = tf = None
    if fst is not None:
        jf = types.SimpleNamespace(msgs_dropped=jnp.int32(fst[0]), msgs_delivered=jnp.int32(fst[1]))
        tf = types.SimpleNamespace(msgs_dropped=torch.tensor(fst[0], dtype=torch.int32),
                                   msgs_delivered=torch.tensor(fst[1], dtype=torch.int32))
    jout = jctl.apply_control(j, jax.random.key(seed), jnp.int32(rnd), jr,
                              **{k: getattr(js, k) for k in common}, row_ptr=jnp.asarray(g.row_ptr),
                              col_idx=jnp.asarray(g.col_idx), rewire_slots=slots, fstats=jf)
    tout = tctl.apply_control(t, prng.key(seed, "cpu"), torch.tensor(rnd, dtype=torch.int32), tr,
                              **{k: getattr(ts, k) for k in common}, row_ptr=torch.from_numpy(g.row_ptr),
                              col_idx=torch.from_numpy(g.col_idx), rewire_slots=slots, fstats=tf)
    for got, want in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype
    for got, want in zip(tout[3], jout[3]):
        assert int(got) == int(want)
    cur, targets, credit, tel = tout
    rewired = planes["rewired"]
    # the credit book still tracks the stored fresh targets of rewired rows
    assert int(credit.sum()) == int((targets.numpy()[rewired] >= 0).sum())
    if name == "refresh_due":
        assert int(tel.refreshed) > 0
    if name == "refresh_off_cadence":
        assert int(tel.refreshed) == 0
    if name in ("loss_widens", "ttl_lag_widens"):
        assert int(cur) >= t.levels  # the stress bit latched
    if name == "saturated_shrink":
        assert int(cur) < cursor


# ------------------------------------------------------------- behaviour

LOSS = {"name": "loss", "phases": [{"name": "l", "start": 0, "end": 12, "loss": 0.5}]}


def test_controller_widens_under_loss():
    """Sustained loss drives the under-delivery signal: the level climbs
    from the clean start onto the stress rung, as in JAX's run."""
    (jc, js), (tc, ts) = swarms(n=200)
    jsc = j_compile_scenario(j_scenario_from_dict(LOSS), n_peers=200, n_slots=200, total_rounds=12)
    tsc = t_compile_scenario(t_scenario_from_dict(LOSS), n_peers=200, n_slots=200, total_rounds=12, device="cpu")
    j, t = controls(target_ratio=0.9, fanout=3, lo=1, hi=5)
    jf, jst = je.simulate(j_clone(js), jc, 12, scenario=jsc, control=j)
    tf, tst = te.simulate(ts, tc, 12, scenario=tsc, control=t)
    assert t_state_digest(tf) == j_state_digest(jf) and t_stats_digest(tst) == j_stats_digest(jst)
    assert int(tst.control_level.max()) == t.levels - 1 and int(tst.control_fanout.max()) == 5


def test_control_none_carries_cursor_untouched():
    (jc, js), (tc, ts) = swarms()
    js.control_lvl = jnp.asarray(4, dtype=jnp.int32)
    ts.control_lvl = torch.tensor(4, dtype=torch.int32)
    jf, jst = je.simulate(j_clone(js), jc, 3)
    tf, tst = te.simulate(ts, tc, 3)
    assert int(tf.control_lvl) == int(jf.control_lvl) == 4
    assert t_state_digest(tf) == j_state_digest(jf)
    assert (tst.control_level == -1).all() and (tst.control_fanout == 0).all()


def test_control_cursor_checkpoint_roundtrip(tmp_path):
    """A controlled run saved mid-way and reloaded replays bit-exactly
    under the same spec, and equals JAX's uninterrupted run."""
    (jc, js), (tc, ts) = swarms()
    j, t = controls(target_ratio=0.9, fanout=3, lo=1, hi=6)
    jf, jst = je.simulate(j_clone(js), jc, 12, control=j)
    mid, _ = te.simulate(ts, tc, 6, control=t)
    save_swarm(tmp_path / "ctl.npz", mid)
    back = load_swarm(tmp_path / "ctl.npz", device="cpu")
    assert int(back.control_lvl) == int(mid.control_lvl) >= 0
    fin, _ = te.simulate(back, tc, 6, control=t)
    assert t_state_digest(fin) == j_state_digest(jf)


# ----------------------------------------------------- reliability report

def test_reliability_report_equals_jax():
    """The epidemic branch, the streaming branch and the all-censored
    horizon, each on both packages' runs of the same swarm."""
    (jc, js), (tc, ts) = swarms(n=200)
    jf, jst = je.simulate(j_clone(js), jc, 20)
    tf, tst = te.simulate(ts, tc, 20)
    for kw in (dict(target_ratio=0.9), dict(target_ratio=0.99, coverage_target=0.95, round_seconds=2.0)):
        assert TM.reliability_report(tst, **kw) == JM.reliability_report(jst, **kw)
    rep = TM.reliability_report(tst, target_ratio=0.9)
    assert rep["messages_judged"] == 1 and rep["holds"] and rep["infections_delivered"] >= 198
    (jc, js), (tc, ts) = swarms(n=96, msg_slots=8)
    for ttl, rounds in ((30, 5), (6, 30)):
        kw = dict(rate=1.0, msg_slots=8, ttl=ttl, origin_rows=np.arange(96))
        jstrm, tstrm = j_compile_stream(**kw), t_compile_stream(**kw, device="cpu")
        _, jst = je.simulate(j_clone(js), jc, rounds, stream=jstrm)
        _, tst = te.simulate(ts, tc, rounds, stream=tstrm)
        got = TM.reliability_report(tst, target_ratio=0.9, coverage_target=0.95)
        assert got == JM.reliability_report(jst, target_ratio=0.9, coverage_target=0.95)
        assert (got["messages_judged"] == 0) == (ttl == 30)
