"""The longer cells of ``tests/sim/test_traffic.py`` as port-against-JAX
equalities on the CPU: a loaded run on the bucketed mesh at S = 1 and 3
(K6 receive, scatter and packed twins), the run to coverage under a
stream, k = 1 conflation and k = 2 Bloom conformance to the closed-form
predictors, the steady-state conflation band, the steady-state report and
the saturation knee; each run equal to JAX's, then the cell's law on the
port's run."""

import numpy as np
import pytest

from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip.sim import metrics as JM
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream import N, run_both, seed_graph, setup, streams

import jax

@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_stream_equals_jax_mesh(s):
    """A loaded run on the bucketed mesh (origins through ``position``),
    K6 receive and scatter twin, and the packed twin: each equal to the JAX
    mesh's run."""
    from tpu_gossip.dist import simulate_dist as j_sim_dist

    from tpu_gossip_torch import dist as tdist
    from tests.test_torch_dist import _build

    graph = seed_graph(200, seed=4)
    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(graph, s, m=8, mode="push_pull", fanout=1)
    _, _, position = tdist.partition_graph(graph, s, seed=1, device="cpu")
    jstrm, tstrm = streams(rate=3.0, msg_slots=8, ttl=8, origin_rows=position[np.arange(200)], burst_every=4)
    jfin, jst = j_sim_dist(js, jc, jsg, jm, 14, None, None, None, stream=jstrm)
    plans = tdist.build_shard_plans(tsg)
    for plan, st in ((plans, ts), (None, ts), (plans, pack_state(ts))):
        tfin, tst = tdist.simulate_dist(st, tc, tsg, tm, 14, plan, stream=tstrm)
        tfin = unpack_state(tfin) if st is not ts else tfin
        assert t_state_digest(tfin) == j_state_digest(jfin) and t_stats_digest(tst) == j_stats_digest(jst)
    assert int(tst.stream_expired.sum()) > 0


def test_run_until_coverage_under_a_stream_equals_jax():
    (jc, js), (tc, ts) = setup(m=8)
    jstrm, tstrm = streams(rate=2.0, msg_slots=8, ttl=30, origin_rows=np.arange(N))
    jf = je.run_until_coverage(js, jc, 0.99, 40, stream=jstrm)
    tf = te.run_until_coverage(ts, tc, 0.99, 40, stream=tstrm)
    assert t_state_digest(tf) == j_state_digest(jf) and int(tf.round) > 0


def test_conflation_rate_conforms_k1():
    _, stats = run_both(setup(m=64, origins=()), 40, streams(rate=4.0, msg_slots=64, ttl=1000,
                                                              origin_rows=np.arange(N)))
    r = int(stats.stream_offered.sum())
    measured, predicted = int(stats.stream_conflated.sum()), TM.expected_conflations(r, 64)
    assert r > 100 and abs(measured - predicted) < 0.15 * predicted


def test_bloom_fp_rate_conforms_k2():
    g = seed_graph()
    kw = dict(n_peers=N, msg_slots=128, fanout=2, mode="push_pull")
    pair = ((JConfig(**kw), j_init(g, JConfig(**kw), key=jax.random.key(5))),
            (TConfig(**kw), t_init(g, TConfig(**kw), key=prng.key(5, "cpu"), device="cpu")))
    _, stats = run_both(pair, 50, streams(rate=6.0, msg_slots=128, ttl=1000, origin_rows=np.arange(N), k_hashes=2))
    off, sup, age = stats.stream_offered.numpy(), stats.stream_conflated.numpy(), stats.slot_age.numpy()
    fill = np.concatenate([[0.0], (age >= 0).mean(axis=1)[:-1]])
    predicted, measured = float((off * fill ** 2).sum()), int(sup.sum())
    assert measured > 50 and abs(measured - predicted) < 0.2 * max(predicted, 1)
    head = 10
    fp_pred = TM.bloom_false_positive_rate(int(stats.stream_injected.numpy()[:head].sum()), 128, 2)
    assert sup[:head].sum() / max(off[:head].sum(), 1) <= fp_pred + 0.1


def test_steady_state_conflation_band_k1():
    rate, ttl = 2.0, 16
    _, stats = run_both(setup(m=64, origins=()), 120, streams(rate=rate, msg_slots=64, ttl=ttl,
                                                               origin_rows=np.arange(N)))
    off, conf = stats.stream_offered.numpy()[40:], stats.stream_conflated.numpy()[40:]
    measured = conf.sum() / max(off.sum(), 1)
    lease = ttl * rate * 64 / (64 + ttl * rate)
    assert abs(measured - lease / 64) < 0.08
    r = rate * ttl
    assert measured < TM.expected_conflations(r + 1, 64) - TM.expected_conflations(r, 64) + 0.02


def test_steady_state_report_on_loaded_run():
    (jc, js), (tc, ts) = setup(m=8)
    jstrm, tstrm = streams(rate=2.0, msg_slots=8, ttl=18, origin_rows=np.arange(N))
    _, jst = je.simulate(js, jc, 80, None, "fused", None, None, jstrm)
    _, tst = te.simulate(ts, tc, 80, stream=tstrm)
    rep = TM.steady_state_report(tst, target=0.9, round_seconds=5.0, warmup_rounds=18)
    assert rep == JM.steady_state_report(jst, target=0.9, round_seconds=5.0, warmup_rounds=18)
    assert rep["episodes_completed"] > 5
    p = rep["rounds_to_coverage"]
    assert p["p50"] is not None and p["p50"] <= p["p99"] < 18
    assert rep["delivered_msgs_per_sec"] == pytest.approx(rep["delivered_per_round"] / 5.0, rel=1e-6, abs=1e-4)
    assert 0 <= rep["delivery_ratio"] <= 1 and rep["msgs_offered"] >= rep["msgs_injected"]


def test_saturation_collapses_delivery_ratio():
    """At half a message a round nearly every closed episode delivers; far
    past the slot budget most arrivals conflate into incumbents."""
    reports = []
    for rate in (0.5, 8.0):
        _, stats = run_both(setup(m=4, origins=()), 80, streams(rate=rate, msg_slots=4, ttl=12,
                                                                 origin_rows=np.arange(N)))
        reports.append(TM.steady_state_report(stats, target=0.9, warmup_rounds=12))
    lo, hi = reports
    assert lo["delivery_ratio"] > 0.6 and hi["conflation_rate"] > lo["conflation_rate"]
    assert hi["delivered_per_round"] < 0.5 * hi["offered_per_round"]


