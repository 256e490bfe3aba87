"""The longer controlled runs against the JAX package on the CPU: a
composed run (a scenario with loss, delay, a churn storm, blackouts and a
join burst, growth, a two-hash stream and the controller with the
PeerSwap refresh) and the two acceptance pairs, each held to JAX's own
run of the same pair: ``scenarios/degraded_under_control.toml`` (static
fanout against the controller) and the Byzantine siege demonstration pair
of ``tests/sim/test_adversary.py`` (quorum 3 holds 0.9 reliability and
0.95 eviction precision, quorum 1 misses).

The JAX halves are pinned in ``tests/jax_pins.json`` (group
``control_pairs``, ``tests/jax_pins.py::control_pairs_case``); the composed
run is recomputed in a child process by :func:`test_jax_pins_are_current`.
No JAX program is compiled in a test worker's own process."""

import numpy as np

from tests.jax_pins import COMPOSED_PAIR, pinned
from tests.test_torch_control_runs import control, pa_graph, run_pinned, swarm
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.faults import compile_scenario, parse_scenario, scenario_from_dict
from tpu_gossip_torch.kernels import liveness as tl
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.traffic import compile_stream


def test_composed_scenario_growth_stream_control_equals_jax():
    """Scenario (loss and delay, then a churn storm with blackouts and a
    join burst), growth, a two-hash stream and the controller with the
    refresh, on one exactly-k run."""
    from tpu_gossip_torch.growth import compile_growth, pad_graph_for_growth

    (want,) = pinned("control_pairs", "composed")
    n, cap, rounds = 200, 224, 15
    g, exists = pad_graph_for_growth(pa_graph(n), cap)
    sw = swarm(g, exists=exists, msg_slots=8, fanout=2, mode="push_pull", churn_leave_prob=0.01,
               churn_join_prob=0.05, rewire_slots=4)
    _, st = run_pinned(sw, rounds, want,
                       scenario=compile_scenario(scenario_from_dict(COMPOSED_PAIR), n_peers=n, n_slots=cap,
                                                 total_rounds=rounds, device="cpu"),
                       growth=compile_growth(n_initial=n, target=cap, n_slots=cap, joins_per_round=2, attach_m=2,
                                             max_join_burst=2, device="cpu"),
                       stream=compile_stream(rate=2.0, msg_slots=8, ttl=10, origin_rows=np.arange(n), k_hashes=2,
                                             device="cpu"),
                       control=control(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=3, ttl=10))
    assert int(st.control_refreshed.sum()) > 0 and int(st.stream_injected.sum()) > 0


# ---------------------------------------------------------- acceptance pairs

def test_degraded_scenario_pair_equals_jax():
    """``scenarios/degraded_under_control.toml``'s demonstration pair, the
    static fanout and the controller on the same config: both runs and
    both reliability reports equal JAX's, and the pair's verdicts are JAX's
    run's. JAX's own run of this pair on the CPU (jax 0.9.0; the slow cell
    ``tests/sim/test_control.py::test_static_fanout_misses_where_controller_holds``)
    gives the static fanout 0.8077 and the controller 0.8846 over 26
    judged messages: the controller raises the delivery ratio without
    reaching the 0.9 target, and the port's runs give the same numbers."""
    path = "scenarios/degraded_under_control.toml"
    n, rounds, ttl = 96, 60, 12
    want = pinned("control_pairs", "degraded")
    sw = swarm(pa_graph(n, native=True), msg_slots=8, fanout=2, mode="push_pull", churn_join_prob=0.02,
               rewire_slots=4)
    sc = compile_scenario(parse_scenario(path), n_peers=n, n_slots=n, total_rounds=rounds, device="cpu")
    strm = compile_stream(rate=1.5, msg_slots=8, ttl=ttl, origin_rows=np.arange(n), device="cpu")
    c = control(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=5, ttl=ttl)
    reports = []
    for ctl, w in zip((None, c), want):
        _, st = run_pinned(sw, rounds, {k: w[k] for k in ("state_digest", "stats_digest")}, scenario=sc,
                           stream=strm, control=ctl)
        got = TM.reliability_report(st, target_ratio=0.9, coverage_target=0.95)
        assert got == w["reliability"]
        reports.append(got)
    static, controlled = reports
    assert not static["holds"] and static["messages_judged"] == controlled["messages_judged"] > 0
    assert controlled["delivery_ratio"] > static["delivery_ratio"]


def test_byzantine_siege_demonstration_pair():
    """``tests/sim/test_adversary.py``'s demonstration pair under
    ``scenarios/byzantine_siege.toml`` with a stream and the controller:
    quorum 1 evicts healthy peers and misses the 0.9 target, quorum 3
    holds it with eviction precision >= 0.95 and quarantines accusers;
    every run equal to JAX's."""
    path = "scenarios/byzantine_siege.toml"
    n, rounds = 96, 55
    want = pinned("control_pairs", "siege")
    sw = swarm(pa_graph(n, m=2, native=True), msg_slots=8, fanout=2, mode="push_pull", rewire_slots=6,
               churn_join_prob=0.02)
    spec = parse_scenario(path)
    spec.validate(total_rounds=rounds, n_peers=n)
    sc = compile_scenario(spec, n_peers=n, n_slots=n, total_rounds=rounds, device="cpu")
    strm = compile_stream(rate=1.5, msg_slots=8, ttl=24, origin_rows=np.arange(n), device="cpu")
    c = control(target_ratio=0.9, fanout=2, lo=1, hi=6, refresh_every=5, ttl=24)
    out = {}
    for k, w in zip((1, 3), want):
        _, st = run_pinned(sw, rounds, w, scenario=sc, stream=strm, control=c,
                           liveness=tl.compile_quorum(k, window=4, budget=2))
        out[k] = (TM.reliability_report(st, target_ratio=0.9, coverage_target=0.95), TM.liveness_report(st))
    (rel1, lv1), (rel3, lv3) = out[1], out[3]
    assert rel1["delivery_ratio"] < 0.9 and not rel1["holds"]
    assert lv1["eviction_precision"] < 0.95 and lv1["false_evictions"] > 20
    assert rel3["delivery_ratio"] >= 0.9 and rel3["holds"]
    assert lv3["eviction_precision"] >= 0.95 and lv3["quarantined"] > 0


def test_jax_pins_are_current():
    """The composed run's pin recomputed by the JAX package in a child
    process."""
    assert jax_in_child("tests.jax_pins", "compute", "control_pairs", ["composed"]) == {
        "composed": pinned("control_pairs", "composed")}
