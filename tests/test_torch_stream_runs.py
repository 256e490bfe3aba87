"""The longer cells of ``tests/sim/test_traffic.py`` as port-against-JAX
equalities on the CPU: a loaded run on the bucketed mesh at S = 1 and 3
(K6 receive, scatter and packed twins), the run to coverage under a
stream, k = 1 conflation and k = 2 Bloom conformance to the closed-form
predictors, the steady-state conflation band, the steady-state report and
the saturation knee; each run equal to JAX's, then the cell's law on the
port's run.

JAX's runs are pinned in ``tests/jax_pins.json`` (group ``stream_runs``,
:func:`jax_stream_run`, ``python -m tests.jax_pins write stream_runs``
with 8 forced host devices), so no test here compiles JAX in its own
process: a whole JAX run compiled in a loaded test worker can abort the
worker. ``test_stream_runs_pins_are_current`` recomputes one in a child
process."""

import numpy as np
import pytest
import torch

from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch import traffic as tt
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.jax_pins import pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream import N, seed_graph

# each run's swarm (``tests.test_torch_stream.setup``'s arguments), rounds
# and stream (``compile_stream``'s, ``origin_rows`` every peer)
RUNS = {
    "until_coverage": (dict(m=8), 40, dict(rate=2.0, msg_slots=8, ttl=30)),
    "conflation_k1": (dict(m=64, origins=()), 40, dict(rate=4.0, msg_slots=64, ttl=1000)),
    "bloom_k2": (dict(m=128, seed=5, origins=(), fanout=2), 50, dict(rate=6.0, msg_slots=128, ttl=1000,
                                                                     k_hashes=2)),
    "band_k1": (dict(m=64, origins=()), 120, dict(rate=2.0, msg_slots=64, ttl=16)),
    "steady_report": (dict(m=8), 80, dict(rate=2.0, msg_slots=8, ttl=18)),
    "saturation_0.5": (dict(m=4, origins=()), 80, dict(rate=0.5, msg_slots=4, ttl=12)),
    "saturation_8.0": (dict(m=4, origins=()), 80, dict(rate=8.0, msg_slots=4, ttl=12)),
}
REPORT = dict(target=0.9, round_seconds=5.0, warmup_rounds=18)
# the bucketed mesh's loaded run: its swarm, rounds and stream
BUCKETED = dict(n=200, m=8, rounds=14, stream=dict(rate=3.0, msg_slots=8, ttl=8, burst_every=4))


def t_setup(m=8, seed=1, origins=(0,), n=N, fanout=2, mode="push_pull"):
    """The port's half of ``tests.test_torch_stream.setup``: (cfg, state)."""
    tc = TConfig(n_peers=n, msg_slots=m, fanout=fanout, mode=mode)
    return tc, t_init(seed_graph(n), tc, origins=list(origins) or None, key=prng.key(seed, "cpu"), device="cpu")


def jax_stream_run(name: str) -> dict:
    """The JAX package's run of ``name`` (:data:`RUNS`, or ``bucketed_sS``
    on an S-device mesh): its digests, the per-round coverage, and the
    steady-state report or the final round where the test reads them."""
    from tpu_gossip.fleet.engine import state_digest, stats_digest
    from tpu_gossip.sim import engine as je
    from tpu_gossip.sim import metrics as JM
    from tests.test_torch_stream import setup, streams

    if name.startswith("bucketed_s"):
        from tpu_gossip.dist import simulate_dist
        from tests.test_torch_dist import _build

        s = int(name[len("bucketed_s"):])
        graph = seed_graph(BUCKETED["n"], seed=4)
        (jc, js, jsg, jm), _ = _build(graph, s, m=BUCKETED["m"], mode="push_pull", fanout=1)
        _, _, position = tdist.partition_graph(graph, s, seed=1, device="cpu")
        jstrm, _ = streams(**BUCKETED["stream"], origin_rows=position[np.arange(BUCKETED["n"])])
        fin, st = simulate_dist(js, jc, jsg, jm, BUCKETED["rounds"], None, None, None, stream=jstrm)
        return {"state_digest": state_digest(fin), "stats_digest": stats_digest(st)}
    swarm, rounds, strm = RUNS[name]
    (jc, js), _ = setup(**swarm)
    jstrm, _ = streams(**strm, origin_rows=np.arange(N))
    if name == "until_coverage":
        fin = je.run_until_coverage(js, jc, 0.99, rounds, stream=jstrm)
        return {"state_digest": state_digest(fin), "round": int(fin.round)}
    fin, st = je.simulate(js, jc, rounds, None, "fused", None, None, jstrm)
    out = {"state_digest": state_digest(fin), "stats_digest": stats_digest(st),
           "coverage": np.asarray(st.coverage).tolist()}
    if name == "steady_report":
        out["report"] = JM.steady_state_report(st, **REPORT)
    return out


def run_pinned(name: str):
    """The port's run of ``name`` (:data:`RUNS`), held to JAX's pinned run:
    the digests and the per-round coverage; returns ``(final state,
    stats)``."""
    swarm, rounds, strm = RUNS[name]
    tc, ts = t_setup(**swarm)
    fin, stats = te.simulate(ts, tc, rounds, stream=tt.compile_stream(**strm, origin_rows=np.arange(N),
                                                                      device="cpu"))
    want = pinned("stream_runs", name)
    assert t_state_digest(fin) == want["state_digest"] and t_stats_digest(stats) == want["stats_digest"]
    np.testing.assert_array_equal(stats.coverage.numpy(), np.asarray(want["coverage"], dtype=np.float32))
    return fin, stats


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_stream_equals_jax_mesh(s):
    """A loaded run on the bucketed mesh (origins through ``position``),
    K6 receive and scatter twin, and the packed twin: each equal to the JAX
    mesh's run."""
    graph = seed_graph(BUCKETED["n"], seed=4)
    tsg, trel, position = tdist.partition_graph(graph, s, seed=1, device="cpu")
    tc = TConfig(n_peers=tsg.n_pad, msg_slots=BUCKETED["m"], mode="push_pull", fanout=1)
    tm = tdist.make_mesh(s, device="cpu")
    ts = tdist.shard_swarm(tdist.init_sharded_swarm(tsg, trel, position, tc, key=prng.key(1, "cpu"), origins=[0, 5],
                                                    device="cpu"), tm)
    tstrm = tt.compile_stream(**BUCKETED["stream"], origin_rows=position[np.arange(BUCKETED["n"])], device="cpu")
    want = pinned("stream_runs", f"bucketed_s{s}")
    plans = tdist.build_shard_plans(tsg)
    for plan, st in ((plans, ts), (None, ts), (plans, pack_state(ts))):
        tfin, tst = tdist.simulate_dist(st, tc, tsg, tm, BUCKETED["rounds"], plan, stream=tstrm)
        tfin = unpack_state(tfin) if st is not ts else tfin
        assert t_state_digest(tfin) == want["state_digest"] and t_stats_digest(tst) == want["stats_digest"]
    assert int(tst.stream_expired.sum()) > 0


def test_run_until_coverage_under_a_stream_equals_jax():
    swarm, rounds, strm = RUNS["until_coverage"]
    tc, ts = t_setup(**swarm)
    tf = te.run_until_coverage(ts, tc, 0.99, rounds, stream=tt.compile_stream(**strm, origin_rows=np.arange(N),
                                                                             device="cpu"))
    want = pinned("stream_runs", "until_coverage")
    assert t_state_digest(tf) == want["state_digest"] and int(tf.round) == want["round"] > 0


def test_conflation_rate_conforms_k1():
    _, stats = run_pinned("conflation_k1")
    r = int(stats.stream_offered.sum())
    measured, predicted = int(stats.stream_conflated.sum()), TM.expected_conflations(r, 64)
    assert r > 100 and abs(measured - predicted) < 0.15 * predicted


def test_bloom_fp_rate_conforms_k2():
    _, stats = run_pinned("bloom_k2")
    off, sup, age = stats.stream_offered.numpy(), stats.stream_conflated.numpy(), stats.slot_age.numpy()
    fill = np.concatenate([[0.0], (age >= 0).mean(axis=1)[:-1]])
    predicted, measured = float((off * fill ** 2).sum()), int(sup.sum())
    assert measured > 50 and abs(measured - predicted) < 0.2 * max(predicted, 1)
    head = 10
    fp_pred = TM.bloom_false_positive_rate(int(stats.stream_injected.numpy()[:head].sum()), 128, 2)
    assert sup[:head].sum() / max(off[:head].sum(), 1) <= fp_pred + 0.1


def test_steady_state_conflation_band_k1():
    rate, ttl = 2.0, 16
    _, stats = run_pinned("band_k1")
    off, conf = stats.stream_offered.numpy()[40:], stats.stream_conflated.numpy()[40:]
    measured = conf.sum() / max(off.sum(), 1)
    lease = ttl * rate * 64 / (64 + ttl * rate)
    assert abs(measured - lease / 64) < 0.08
    r = rate * ttl
    assert measured < TM.expected_conflations(r + 1, 64) - TM.expected_conflations(r, 64) + 0.02


def test_steady_state_report_on_loaded_run():
    _, tst = run_pinned("steady_report")
    rep = TM.steady_state_report(tst, **REPORT)
    assert rep == pinned("stream_runs", "steady_report")["report"]
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
        _, stats = run_pinned(f"saturation_{rate}")
        reports.append(TM.steady_state_report(stats, target=0.9, warmup_rounds=12))
    lo, hi = reports
    assert lo["delivery_ratio"] > 0.6 and hi["conflation_rate"] > lo["conflation_rate"]
    assert hi["delivered_per_round"] < 0.5 * hi["offered_per_round"]


def test_stream_runs_pins_are_current():
    """One of the group's JAX runs, recomputed by the JAX package in a
    child process, equals the file."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    names = ["until_coverage"]
    assert jax_in_child("tests.jax_pins", "compute", "stream_runs", names) == {
        name: pinned("stream_runs", name) for name in names}
