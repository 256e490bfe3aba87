"""Controlled runs on every ported engine against the JAX package on the
CPU: the zero-adjustment identity (bounds pinned to the static fanout, no
refresh: the protocol trajectory is the uncontrolled one, only the
controller's cursor and columns move) on the exactly-k, staircase,
matching and bucketed engines, as ``tests/sim/test_control.py``'s
``test_zero_adjustment_*`` cells; active control with the PeerSwap refresh
on each engine, packed twins and the compact side paths included. The
composed run and the acceptance pairs are
``test_torch_control_pairs.py``'s.

The JAX halves are pinned in ``tests/jax_pins.json`` (group
``control_runs``, ``tests/jax_pins.py::control_runs_case`` builds each from
the same arguments) and recomputed by :func:`test_jax_pins_are_current` in
a child process: no JAX program is compiled in a test worker's own
process."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.jax_pins import CONTROL_RUNS, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch import control as tctl
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph as t_matching
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest

CHURN = dict(churn_leave_prob=0.01, churn_join_prob=0.05, rewire_slots=3)
PROTOCOL_STATS = ("coverage", "msgs_sent", "n_infected", "n_alive", "n_declared_dead", "msgs_dropped", "msgs_held",
                  "msgs_delivered", "n_members")


def pa_graph(n=300, seed=0, m=3, native=False):
    return build_csr(n, preferential_attachment(n, m=m, use_native=native, rng=np.random.default_rng(seed)))


def swarm(g, seed=0, exists=None, **kw):
    tc = TConfig(n_peers=g.n, **kw)
    t_exists = None if exists is None else torch.from_numpy(np.asarray(exists))
    return tc, t_init(g, tc, origins=[0], exists=t_exists, key=prng.key(seed, "cpu"), device="cpu")


def matching_swarm(n, fanout, key, slots):
    tg, tmp = t_matching(n, gamma=2.5, fanout=fanout, key=prng.key(key, "cpu"), device="cpu")
    tc = TConfig(n_peers=tg.n_pad, msg_slots=slots, fanout=fanout, mode="push_pull")
    return (tc, t_init(tg.as_padded_graph(), tc, origins=[0], exists=tg.exists, key=prng.key(key, "cpu"),
                       device="cpu")), tmp


def control(**kw):
    return tctl.compile_control(**kw, device="cpu")


def run_pinned(sw, rounds, want, plan=None, packed=False, **kw):
    """The port's run (packed with ``packed``), asserted equal to the JAX
    digests ``want``; returns its (unpacked) final state and stats."""
    tc, ts = sw
    tf, tst = te.simulate(pack_state(ts) if packed else ts, tc, rounds, plan, **kw)
    tf = unpack_state(tf) if packed else tf
    assert {"state_digest": t_state_digest(tf), "stats_digest": t_stats_digest(tst)} == want
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
    want = pinned("control_runs", f"zero_exactly_k_{mode}")
    sw = swarm(pa_graph(), msg_slots=4, fanout=3, mode=mode, **CHURN)
    plain = run_pinned(sw, 15, want[0])
    assert_zero_adjustment(plain, run_pinned(sw, 15, want[1], control=control(target_ratio=0.9, fanout=3, lo=3,
                                                                                hi=3)))


def test_zero_adjustment_staircase_and_matching():
    want = pinned("control_runs", "zero_staircase_matching")
    g = pa_graph()
    sw = swarm(g, msg_slots=4, fanout=2, mode="push_pull")
    tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=2, device="cpu")
    z = control(target_ratio=0.9, fanout=2, lo=2, hi=2)
    plain = run_pinned(sw, 12, want[0], tp)
    assert_zero_adjustment(plain, run_pinned(sw, 12, want[1], tp, control=z))
    pm, tmp = matching_swarm(256, 2, 0, 4)
    plain = run_pinned(pm, 12, want[2], tmp)
    assert_zero_adjustment(plain, run_pinned(pm, 12, want[3], tmp, control=z))


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_zero_adjustment_and_active_control(s):
    """The bucketed engine: zero adjustment reproduces its own uncontrolled
    run; active control with the refresh (K6 receive, the scatter twin
    and the packed twin) equals the JAX mesh's run."""
    (want,) = pinned("control_runs", f"bucketed_active_s{s}")
    tsg, trel, tpos = tdist.partition_graph(pa_graph(400), s, seed=1, window=1024, device="cpu")
    tc = TConfig(n_peers=tsg.n_pad, msg_slots=4, mode="push_pull", fanout=3, churn_leave_prob=0.01,
                 churn_join_prob=0.05, rewire_slots=5)
    tm = tdist.make_mesh(s, device="cpu")
    ts = tdist.shard_swarm(tdist.init_sharded_swarm(tsg, trel, tpos, tc, key=prng.key(1, "cpu"), origins=[0, 5],
                                                    device="cpu"), tm)
    plans = tdist.build_shard_plans(tsg)
    z = control(target_ratio=0.9, fanout=3, lo=3, hi=3)
    plain = tdist.simulate_dist(ts, tc, tsg, tm, 12, plans)
    assert_zero_adjustment(plain, tdist.simulate_dist(ts, tc, tsg, tm, 12, plans, control=z))
    a = control(target_ratio=0.9, fanout=3, lo=1, hi=5, refresh_every=4)
    for plan, st in ((plans, ts), (None, ts), (plans, pack_state(ts))):
        tf, tst = tdist.simulate_dist(st, tc, tsg, tm, 12, plan, control=a)
        tf = unpack_state(tf) if st is not ts else tf
        assert {"state_digest": t_state_digest(tf), "stats_digest": t_stats_digest(tst)} == want
    assert float(tst.coverage[-1]) > 0.9 and int(tst.control_refreshed.sum()) > 0


# -------------------------------------------------------- active control

@pytest.mark.parametrize("cap", [0, 64])
def test_controlled_exactly_k_with_refresh_equals_jax(cap):
    """Active bounds, the needy gate and the refresh on the exactly-k path,
    dense and compact side paths, and the packed twin; the credit book
    balances after the swaps."""
    (want,) = pinned("control_runs", f"controlled_exactly_k_cap{cap}")
    sw = swarm(pa_graph(), msg_slots=4, fanout=3, mode="push_pull", rewire_compact_cap=cap, **CHURN)
    c = control(target_ratio=0.9, fanout=3, lo=1, hi=3, refresh_every=2)
    for packed in (False, True):
        fin, st = run_pinned(sw, 20, want, packed=packed, control=c)
    refreshed = st.control_refreshed.numpy()
    assert refreshed.sum() > 0 and (refreshed[np.arange(1, 21) % 2 != 0] == 0).all()
    rewired = fin.rewired.numpy()
    assert int(fin.degree_credit.sum()) == int((fin.rewire_targets.numpy()[rewired] >= 0).sum())


def test_controlled_staircase_and_matching_equal_jax():
    want = pinned("control_runs", "controlled_staircase_matching")
    g = pa_graph()
    sw = swarm(g, msg_slots=4, fanout=3, mode="push_pull", rewire_slots=5, churn_join_prob=0.05)
    tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=3, device="cpu")
    _, st = run_pinned(sw, 16, want[0], tp, control=control(target_ratio=0.99, fanout=3, lo=1, hi=5,
                                                            refresh_every=3))
    assert len(set(st.control_fanout.tolist())) > 2
    pm, tmp = matching_swarm(2000, 2, 1, 8)
    c = control(target_ratio=0.9, fanout=2, lo=1, hi=4)
    for packed in (False, True):
        _, st = run_pinned(pm, 16, want[1], tmp, packed=packed, control=c)
    assert st.control_fanout[0] == 4 and st.control_fanout[-1] < 4


def test_jax_pins_are_current():
    """A case of the group recomputed by the JAX package in a child
    process: the compact side paths with the refresh."""
    names = ["controlled_exactly_k_cap64"]
    assert set(names) <= set(CONTROL_RUNS)
    got = jax_in_child("tests.jax_pins", "compute", "control_runs", names)
    assert got == {name: pinned("control_runs", name) for name in names}
