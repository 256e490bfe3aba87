"""The CSR delivery family against the JAX package, bit for bit: staircase
plan tables (host and device builds), K5's plain version against the JAX
kernel in interpret mode, segment_or / segment_sampled on JAX's own plans,
and whole runs over a Chung-Lu graph through the exactly-k XLA delivery
and the staircase kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import topology as jt
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as jinit
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.kernels import pallas_segment as jseg
from tpu_gossip.sim.engine import run_until_coverage as jrun
from tpu_gossip.sim.engine import simulate as jsim
from tpu_gossip_torch import convert
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as tinit
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tpu_gossip_torch.sim.engine import run_until_coverage as trun
from tpu_gossip_torch.sim.engine import simulate as tsim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

TABLES = ("tile_block", "offs", "col_gather", "push_thresh", "pull_thresh")


def chung_lu(n, seed=0, gamma=2.5):
    rng = np.random.default_rng(seed)
    deg = jt.powerlaw_degree_sequence(n, gamma=gamma, rng=rng)
    return jt.build_csr(n, jt.configuration_model(deg, rng=rng))


def hub_csr(hub_deg=5000, n=9):
    """Row 0 holds ``hub_deg`` in-edges, so its slots span several tiles."""
    deg = np.array([hub_deg] + [3] * (n - 1))
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = np.arange(row_ptr[-1], dtype=np.int32) % n
    return row_ptr, col_idx


def assert_same_plan(tp, jp):
    for name in ("n", "n_tiles", "n_blocks", "fanout", "rows"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in TABLES:
        a, b = getattr(jp, name), getattr(tp, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype), err_msg=name)


@pytest.mark.parametrize("rows", [128, 512, 1024])
@pytest.mark.parametrize("fanout", [None, 2])
def test_host_and_device_plans_equal_jax(rows, fanout):
    g = chung_lu(3000, seed=rows)
    assert_same_plan(tseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout, rows=rows, device="cpu"),
                     jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout, rows=rows))
    tdev = tseg.build_staircase_plan_device(torch.from_numpy(g.row_ptr), torch.from_numpy(g.col_idx), fanout,
                                            rows=rows)
    assert_same_plan(tdev, jseg.build_staircase_plan_device(jnp.asarray(g.row_ptr), jnp.asarray(g.col_idx),
                                                            fanout, rows=rows))


@pytest.mark.parametrize("case", ["forced_tiles", "hub", "edgeless", "sentinel_graph"])
def test_plan_edge_cases_equal_jax(case):
    if case == "forced_tiles":
        g = chung_lu(2000, seed=4)
        rp, ci, kw = g.row_ptr, g.col_idx, dict(rows=256, n_tiles=40)
    elif case == "hub":
        (rp, ci), kw = hub_csr(), dict(rows=128)
    elif case == "edgeless":
        rp, ci, kw = np.zeros(301, np.int32), np.zeros(0, np.int32), dict(rows=128)
    else:
        from tpu_gossip.core.device_topology import device_powerlaw_graph

        dg = device_powerlaw_graph(4000, key=jax.random.key(1))
        rp, ci, kw = np.asarray(dg.row_ptr), np.asarray(dg.col_idx), {}
    tp = tseg.build_staircase_plan(rp, ci, 1, device="cpu", **kw)
    assert_same_plan(tp, jseg.build_staircase_plan(rp, ci, 1, **kw))
    if "n_tiles" in kw:
        return
    tdev = tseg.build_staircase_plan_device(torch.tensor(rp), torch.tensor(ci), 1, **kw)
    # the JAX device build cannot gather from an empty CSR; there every
    # threshold is 0, so the host tables are the reference
    assert_same_plan(tdev, tp if case == "edgeless" else
                     jseg.build_staircase_plan_device(jnp.asarray(rp), jnp.asarray(ci), 1, **kw))


def _words(shape, seed, m):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    w[rng.random(shape) < 0.4] = 0
    if m < 32:
        w &= np.int32((1 << m) - 1) if m < 31 else np.int32(0x7FFFFFFF)
    return w


@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("billed", [False, True])
@pytest.mark.parametrize("graph", ["chung_lu", "hub"])
def test_staircase_plain_equals_jax_kernel(m, billed, graph):
    if graph == "hub":
        (rp, ci), rows = hub_csr(), 128
    else:
        g, rows = chung_lu(2500, seed=m), 512
        rp, ci = g.row_ptr, g.col_idx
    jp = jseg.build_staircase_plan(rp, ci, rows=rows)
    tp = tseg.build_staircase_plan(rp, ci, rows=rows, device="cpu")
    vals = _words(tp.offs.shape, m, m)
    if m == 32:
        vals[0, 0] = np.int32(-2**31)  # bit 31 alone
    bill = np.random.default_rng(7).integers(0, 40, tp.offs.shape).astype(np.int32) if billed else None
    want = jseg._launch(jp, jnp.asarray(vals), m, True, None if bill is None else jnp.asarray(bill))
    got = tseg._launch(tp, torch.from_numpy(vals), m, None if bill is None else torch.from_numpy(bill))
    if billed:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_staircase_segment_takes_plain_on_cpu_and_counts_nothing():
    from tpu_gossip_torch.kernels import native

    tp = tseg.build_staircase_plan(*hub_csr(), rows=128, device="cpu")
    vals = torch.from_numpy(_words(tp.offs.shape, 1, 32))
    before = native.LAUNCHES["staircase_segment"]
    got = tseg.staircase_segment(tp.tile_block, tp.offs, vals, tp.rows, tp.n_blocks)
    want = tseg.staircase_plain(tp.tile_block, tp.offs, vals, tp.rows, tp.n_blocks)
    assert torch.equal(got[0], want[0]) and got[1] is None
    assert native.LAUNCHES["staircase_segment"] == before
    with pytest.raises(ValueError):
        tseg.staircase_segment(tp.tile_block, tp.offs, vals[:8], tp.rows, tp.n_blocks)


def _jax_plan_to_port(jp):
    leaves = {name: None if getattr(jp, name) is None else np.asarray(getattr(jp, name))
              for name in convert.STAIRCASE_LEAVES}
    return convert.staircase_plan_from_jax(leaves, {k: getattr(jp, k) for k in convert.STAIRCASE_STATIC},
                                           device="cpu")


@pytest.mark.parametrize("m", [16, 40])
def test_segment_or_on_jax_plan_equals_jax(m):
    g = chung_lu(3000, seed=1)
    jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, rows=512)
    tp = _jax_plan_to_port(jp)
    tx = np.random.default_rng(m).random((g.n, m)) < 0.2
    want = jseg.segment_or(jp, jnp.asarray(tx), m)
    np.testing.assert_array_equal(tseg.segment_or(tp, torch.from_numpy(tx), m).numpy(), np.asarray(want))


@pytest.mark.parametrize("m,do_pull,gated,answer", [(40, True, True, False), (40, True, False, True),
                                                     (16, False, True, False), (16, True, True, True)])
def test_segment_sampled_on_jax_plan_equals_jax(m, do_pull, gated, answer):
    g = chung_lu(3000, seed=2)
    jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=1)
    tp = _jax_plan_to_port(jp)
    rng = np.random.default_rng(m + 3)
    tx = rng.random((g.n, m)) < 0.3
    ans = (tx | (rng.random((g.n, m)) < 0.2)) if answer else None
    rec = (rng.random(g.n) < 0.8) if gated else None
    jinc, jmsgs = jseg.segment_sampled(
        jp, jnp.asarray(tx), None if ans is None else jnp.asarray(ans), m, jax.random.key(9),
        receptive_rows=None if rec is None else jnp.asarray(rec), do_push=True, do_pull=do_pull)
    tinc, tmsgs = tseg.segment_sampled(
        tp, torch.from_numpy(tx), None if ans is None else torch.from_numpy(ans), m, prng.key(9, "cpu"),
        receptive_rows=None if rec is None else torch.from_numpy(rec), do_push=True, do_pull=do_pull)
    np.testing.assert_array_equal(tinc.numpy(), np.asarray(jinc))
    assert int(tmsgs) == int(jmsgs) > 0
    assert tmsgs.dtype == torch.int32


def test_segment_sampled_refuses_controller_hooks():
    """The controller's hooks are its round decision: a 0-d effective
    fanout and pull gate and an (N,) needy mask; anything else is refused
    (the hooks themselves run: ``test_torch_control_kernels.py``)."""
    tp = tseg.build_staircase_plan(*hub_csr(), fanout=1, rows=128, device="cpu")
    tx = torch.ones((9, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="pull_gate"):
        tseg.segment_sampled(tp, tx, None, 4, prng.key(0, "cpu"), pull_gate=tx[:, 0])


def build_both_csr(n, seed=0, staircase=False, **cfg_kw):
    """The same Chung-Lu swarm and (optionally) staircase plan in both packages."""
    g = chung_lu(n, seed)
    kw = dict(n_peers=n, msg_slots=16, **cfg_kw)
    origins = np.random.default_rng(seed + 100).choice(n, size=1, replace=False)
    js = jinit(g, JConfig(**kw), key=jax.random.key(seed), origins=origins)
    ts = tinit(g, TConfig(**kw), key=prng.key(seed, "cpu"), origins=origins, device="cpu")
    jp = tp = None
    if staircase:
        fan = None if kw.get("mode") == "flood" else kw.get("fanout", 3)
        jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fan)
        tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, fan, device="cpu")
    return (JConfig(**kw), js, jp), (TConfig(**kw), ts, tp)


def build_port_csr(n, seed=0, staircase=False, **cfg_kw):
    """The port's half of :func:`build_both_csr`: ``(cfg, state, plan)``."""
    g = chung_lu(n, seed)
    kw = dict(n_peers=n, msg_slots=16, **cfg_kw)
    origins = np.random.default_rng(seed + 100).choice(n, size=1, replace=False)
    ts = tinit(g, TConfig(**kw), key=prng.key(seed, "cpu"), origins=origins, device="cpu")
    tp = None
    if staircase:
        tp = tseg.build_staircase_plan(g.row_ptr, g.col_idx, None if kw.get("mode") == "flood" else
                                       kw.get("fanout", 3), device="cpu")
    return TConfig(**kw), ts, tp


RUNS = {
    "xla_push_f3": (dict(mode="push", fanout=3), False),
    "xla_push_pull_f1": (dict(mode="push_pull", fanout=1), False),
    "xla_flood": (dict(mode="flood"), False),
    "staircase_push_pull_f1": (dict(mode="push_pull", fanout=1), True),
    "staircase_flood": (dict(mode="flood"), True),
    "staircase_push_f2_forward_once_sir": (dict(mode="push", fanout=2, forward_once=True,
                                                sir_recover_rounds=4), True),
}


def jax_simulate_digests(name: str) -> dict:
    """The JAX half of :func:`test_simulate_digests_equal_jax`: its run's
    state and stats digests and coverage column."""
    cfg_kw, staircase = RUNS[name]
    (jc, js, jp), _ = build_both_csr(2000, seed=1, staircase=staircase, **cfg_kw)
    jf, jst = jsim(js, jc, 20, jp)
    return dict(state=j_state_digest(jf), stats=j_stats_digest(jst), coverage=np.asarray(jst.coverage).tolist())


@pytest.mark.parametrize("name", list(RUNS))
def test_simulate_digests_equal_jax(name):
    """Each run equal to JAX's, pinned in ``tests/jax_pins.json`` (group
    ``staircase``: a test worker's XLA CPU compiler has died under the
    suite's load on the JAX half; :func:`test_simulate_pins_are_current`
    recomputes one in a child process)."""
    from tests.jax_pins import pinned

    cfg_kw, staircase = RUNS[name]
    tc, ts, tp = build_port_csr(2000, seed=1, staircase=staircase, **cfg_kw)
    want = pinned("staircase", name)
    tf, tst = tsim(ts, tc, 20, tp)
    assert t_state_digest(tf) == want["state"]
    assert t_stats_digest(tst) == want["stats"]
    np.testing.assert_array_equal(np.asarray(want["coverage"], dtype=np.float32), tst.coverage.numpy())
    assert int(tst.msgs_sent.sum()) > 0


def test_simulate_pins_are_current():
    """One run of the ``staircase`` group recomputed by the JAX package in a
    child process."""
    from tests.jax_pins import pinned
    from tests.test_torch_growth_cli_engines import jax_in_child

    name = "staircase_push_f2_forward_once_sir"
    assert jax_in_child("tests.test_torch_staircase", "jax_simulate_digests", name) == pinned("staircase", name)


@pytest.mark.parametrize("staircase", [False, True])
def test_run_until_coverage_rounds_equal_jax(staircase):
    (jc, js, jp), (tc, ts, tp) = build_both_csr(2000, seed=2, staircase=staircase, mode="push_pull", fanout=1)
    jf = jrun(js, jc, 0.99, 1000, plan=jp)
    tf = trun(ts, tc, 0.99, 1000, plan=tp)
    assert int(tf.round) == int(jf.round) > 0
    assert t_state_digest(tf) == j_state_digest(jf)


def test_device_graph_with_device_plan_runs_like_jax():
    """The slice's path at test size: the device generator's sentinel-row
    graph, the device-built plan, staircase push_pull."""
    from tpu_gossip.core.device_topology import device_powerlaw_graph as jdev
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph as tdev

    n = 3000
    jg, tg = jdev(n, key=jax.random.key(0)), tdev(n, key=prng.key(0, "cpu"), device="cpu")
    kw = dict(n_peers=n + 1, msg_slots=16, mode="push_pull", fanout=1)
    origins = np.random.default_rng(0).choice(n, size=1, replace=False)
    js = jinit(jg.as_padded_graph(), JConfig(**kw), key=jax.random.key(0), origins=origins, exists=jg.exists)
    ts = tinit(tg.as_padded_graph(), TConfig(**kw), key=prng.key(0, "cpu"), origins=origins, exists=tg.exists,
               device="cpu")
    jp = jseg.build_staircase_plan_device(jg.row_ptr, jg.col_idx, fanout=1)
    tp = tseg.build_staircase_plan_device(tg.row_ptr, tg.col_idx, fanout=1)
    jf, jst = jsim(js, JConfig(**kw), 15, jp)
    tf, tst = tsim(ts, TConfig(**kw), 15, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
