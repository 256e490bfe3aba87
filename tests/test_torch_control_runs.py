"""Controlled runs on every ported engine against the JAX package on the
CPU: the zero-adjustment identity (bounds pinned to the static fanout, no
refresh: the protocol trajectory is the uncontrolled one, only the
controller's cursor and columns move) on the exactly-k, staircase,
matching and bucketed engines, as ``tests/sim/test_control.py``'s
``test_zero_adjustment_*`` cells; active control with the PeerSwap refresh
on each engine, packed twins and the compact side paths included. The
composed run and the acceptance pairs are
``test_torch_control_pairs.py``'s."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_gossip import control as jctl
from tpu_gossip.core.matching_topology import matching_powerlaw_graph as j_matching
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import clone_state as j_clone
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.core.topology import build_csr, preferential_attachment
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.kernels import pallas_segment as jseg
from tpu_gossip.sim import engine as je
from tpu_gossip_torch import control as tctl
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph as t_matching
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_dist import _build
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

CHURN = dict(churn_leave_prob=0.01, churn_join_prob=0.05, rewire_slots=3)
PROTOCOL_STATS = ("coverage", "msgs_sent", "n_infected", "n_alive", "n_declared_dead", "msgs_dropped", "msgs_held",
                  "msgs_delivered", "n_members")


def pa_graph(n=300, seed=0, m=3, native=False):
    return build_csr(n, preferential_attachment(n, m=m, use_native=native, rng=np.random.default_rng(seed)))


def pair(g, n_peers=None, seed=0, exists=None, **kw):
    kw = dict(n_peers=g.n if n_peers is None else n_peers, **kw)
    jc, tc = JConfig(**kw), TConfig(**kw)
    t_exists = None if exists is None else torch.from_numpy(np.asarray(exists))
    return ((jc, j_init(g, jc, origins=[0], exists=exists, key=jax.random.key(seed))),
            (tc, t_init(g, tc, origins=[0], exists=t_exists, key=prng.key(seed, "cpu"), device="cpu")))


def controls(**kw):
    return jctl.compile_control(**kw), tctl.compile_control(**kw, device="cpu")


def run_both(pair_, rounds, jplan=None, tplan=None, jkw=None, tkw=None, packed=False):
    """Both packages' runs (the port's packed with ``packed``); asserts them
    equal; returns the port's (unpacked) final state and stats (JAX's
    stats ride along as ``run_both.jax_stats``)."""
    (jc, js), (tc, ts) = pair_
    jf, jst = je.simulate(j_clone(js), jc, rounds, jplan, **(jkw or {}))
    tf, tst = te.simulate(pack_state(ts) if packed else ts, tc, rounds, tplan, **(tkw or {}))
    tf = unpack_state(tf) if packed else tf
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    run_both.jax_stats = jst
    return tf, tst


def assert_zero_adjustment(plain, zero):
    """The zero-adjustment run's protocol trajectory is the uncontrolled
    one's: every plane but the cursor and every protocol column."""
    (f0, s0), (fz, sz) = plain, zero
    for f in dataclasses.fields(f0):
        if f.name != "control_lvl":
            assert torch.equal(getattr(f0, f.name), getattr(fz, f.name)), f.name
    for name in PROTOCOL_STATS:
        assert torch.equal(getattr(s0, name), getattr(sz, name)), name
    assert (s0.control_level == -1).all() and (s0.control_fanout == 0).all()
    assert (sz.control_level == 0).all() and (sz.control_fanout > 0).all()


# ------------------------------------------------------ zero adjustment

@pytest.mark.parametrize("mode", ["push", "push_pull"])
def test_zero_adjustment_exactly_k(mode):
    p = pair(pa_graph(), msg_slots=4, fanout=3, mode=mode, **CHURN)
    z = controls(target_ratio=0.9, fanout=3, lo=3, hi=3)
    plain = run_both(p, 15)
    assert_zero_adjustment(plain, run_both(p, 15, jkw=dict(control=z[0]), tkw=dict(control=z[1])))


def test_zero_adjustment_staircase_and_matching():
    g = pa_graph()
    p = pair(g, msg_slots=4, fanout=2, mode="push_pull")
    jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=2)
    tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=2, device="cpu")
    z = controls(target_ratio=0.9, fanout=2, lo=2, hi=2)
    plain = run_both(p, 12, jp, tp)
    assert_zero_adjustment(plain, run_both(p, 12, jp, tp, dict(control=z[0]), dict(control=z[1])))
    jg, jmp = j_matching(256, gamma=2.5, fanout=2, key=jax.random.key(0))
    tg, tmp = t_matching(256, gamma=2.5, fanout=2, key=prng.key(0, "cpu"), device="cpu")
    kw = dict(n_peers=jg.n_pad, msg_slots=4, fanout=2, mode="push_pull")
    jc, tc = JConfig(**kw), TConfig(**kw)
    pm = ((jc, j_init(jg.as_padded_graph(), jc, origins=[0], exists=jg.exists, key=jax.random.key(0))),
          (tc, t_init(tg.as_padded_graph(), tc, origins=[0], exists=tg.exists, key=prng.key(0, "cpu"),
                      device="cpu")))
    plain = run_both(pm, 12, jmp, tmp)
    assert_zero_adjustment(plain, run_both(pm, 12, jmp, tmp, dict(control=z[0]), dict(control=z[1])))


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_zero_adjustment_and_active_control(s):
    """The bucketed engine: zero adjustment reproduces its own uncontrolled
    run; active control with the refresh (K6 receive, the scatter twin
    and the packed twin) equals the JAX mesh's run."""
    from tpu_gossip.dist import simulate_dist as j_sim_dist

    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(pa_graph(400), s, m=4, mode="push_pull", fanout=3,
                                                  churn_leave_prob=0.01, churn_join_prob=0.05, rewire_slots=5)
    plans = tdist.build_shard_plans(tsg)
    z = controls(target_ratio=0.9, fanout=3, lo=3, hi=3)
    plain = tdist.simulate_dist(ts, tc, tsg, tm, 12, plans)
    assert_zero_adjustment(plain, tdist.simulate_dist(ts, tc, tsg, tm, 12, plans, control=z[1]))
    a = controls(target_ratio=0.9, fanout=3, lo=1, hi=5, refresh_every=4)
    jf, jst = j_sim_dist(j_clone(js), jc, jsg, jm, 12, control=a[0])
    for plan, st in ((plans, ts), (None, ts), (plans, pack_state(ts))):
        tf, tst = tdist.simulate_dist(st, tc, tsg, tm, 12, plan, control=a[1])
        tf = unpack_state(tf) if st is not ts else tf
        assert t_state_digest(tf) == j_state_digest(jf) and t_stats_digest(tst) == j_stats_digest(jst)
    assert float(tst.coverage[-1]) > 0.9 and int(tst.control_refreshed.sum()) > 0


# -------------------------------------------------------- active control

@pytest.mark.parametrize("cap", [0, 64])
def test_controlled_exactly_k_with_refresh_equals_jax(cap):
    """Active bounds, the needy gate and the refresh on the exactly-k path,
    dense and compact side paths, and the packed twin; the credit book
    balances after the swaps."""
    p = pair(pa_graph(), msg_slots=4, fanout=3, mode="push_pull", rewire_compact_cap=cap, **CHURN)
    c = controls(target_ratio=0.9, fanout=3, lo=1, hi=3, refresh_every=2)
    for packed in (False, True):
        fin, st = run_both(p, 20, jkw=dict(control=c[0]), tkw=dict(control=c[1]), packed=packed)
    refreshed = st.control_refreshed.numpy()
    assert refreshed.sum() > 0 and (refreshed[np.arange(1, 21) % 2 != 0] == 0).all()
    rewired = fin.rewired.numpy()
    assert int(fin.degree_credit.sum()) == int((fin.rewire_targets.numpy()[rewired] >= 0).sum())


def test_controlled_staircase_and_matching_equal_jax():
    g = pa_graph()
    p = pair(g, msg_slots=4, fanout=3, mode="push_pull", rewire_slots=5, churn_join_prob=0.05)
    jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=3)
    tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=3, device="cpu")
    c = controls(target_ratio=0.99, fanout=3, lo=1, hi=5, refresh_every=3)
    _, st = run_both(p, 16, jp, tp, dict(control=c[0]), dict(control=c[1]))
    assert len(set(st.control_fanout.tolist())) > 2
    jg, jmp = j_matching(2000, gamma=2.5, fanout=2, key=jax.random.key(1))
    tg, tmp = t_matching(2000, gamma=2.5, fanout=2, key=prng.key(1, "cpu"), device="cpu")
    kw = dict(n_peers=jg.n_pad, msg_slots=8, fanout=2, mode="push_pull")
    jc, tc = JConfig(**kw), TConfig(**kw)
    pm = ((jc, j_init(jg.as_padded_graph(), jc, origins=[0], exists=jg.exists, key=jax.random.key(1))),
          (tc, t_init(tg.as_padded_graph(), tc, origins=[0], exists=tg.exists, key=prng.key(1, "cpu"),
                      device="cpu")))
    c = controls(target_ratio=0.9, fanout=2, lo=1, hi=4)
    for packed in (False, True):
        _, st = run_both(pm, 16, jmp, tmp, dict(control=c[0]), dict(control=c[1]), packed=packed)
    assert st.control_fanout[0] == 4 and st.control_fanout[-1] < 4
