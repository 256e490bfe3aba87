"""The longer controlled runs against the JAX package on the CPU: a
composed run (a scenario with loss, delay, a churn storm, blackouts and a
join burst, growth, a two-hash stream and the controller with the
PeerSwap refresh) and the two acceptance pairs, each held to JAX's own
run of the same pair: ``scenarios/degraded_under_control.toml`` (static
fanout against the controller) and the Byzantine siege demonstration pair
of ``tests/sim/test_adversary.py`` (quorum 3 holds 0.9 reliability and
0.95 eviction precision, quorum 1 misses)."""

import numpy as np

from tpu_gossip.faults import compile_scenario as j_compile_scenario
from tpu_gossip.faults import parse_scenario as j_parse_scenario
from tpu_gossip.kernels import liveness as jl
from tpu_gossip.sim import metrics as JM
from tpu_gossip.traffic import compile_stream as j_compile_stream
from tpu_gossip_torch.faults import compile_scenario as t_compile_scenario
from tpu_gossip_torch.faults import parse_scenario as t_parse_scenario
from tpu_gossip_torch.kernels import liveness as tl
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.traffic import compile_stream as t_compile_stream
from tests.test_torch_control_runs import controls, pa_graph, pair, run_both
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def test_composed_scenario_growth_stream_control_equals_jax():
    """Scenario (loss and delay, then a churn storm with blackouts and a
    join burst), growth, a two-hash stream and the controller with the
    refresh, on one exactly-k run."""
    from tpu_gossip.faults import scenario_from_dict as j_sfd
    from tpu_gossip.growth import compile_growth as j_growth
    from tpu_gossip.growth import pad_graph_for_growth as j_pad
    from tpu_gossip_torch.faults import scenario_from_dict as t_sfd
    from tpu_gossip_torch.growth import compile_growth as t_growth

    n, cap, rounds = 200, 224, 15
    g, exists = j_pad(pa_graph(n), cap)
    p = pair(g, msg_slots=8, fanout=2, mode="push_pull", exists=exists, churn_leave_prob=0.01, churn_join_prob=0.05,
             rewire_slots=4)
    d = {"name": "t", "phases": [
        {"name": "lossy", "start": 1, "end": 5, "loss": 0.2, "delay": 0.2},
        {"name": "storm", "start": 5, "end": 9, "churn_leave": 0.05, "churn_join": 0.2,
         "blackout": {"frac": 0.1, "seed": 1}, "join_burst": 2}]}
    sc_kw = dict(n_peers=n, n_slots=cap, total_rounds=rounds)
    gr_kw = dict(n_initial=n, target=cap, n_slots=cap, joins_per_round=2, attach_m=2, max_join_burst=2)
    st_kw = dict(rate=2.0, msg_slots=8, ttl=10, origin_rows=np.arange(n), k_hashes=2)
    c = controls(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=3, ttl=10)
    _, st = run_both(p, rounds,
                     jkw=dict(scenario=j_compile_scenario(j_sfd(d), **sc_kw), growth=j_growth(**gr_kw),
                              stream=j_compile_stream(**st_kw), control=c[0]),
                     tkw=dict(scenario=t_compile_scenario(t_sfd(d), **sc_kw, device="cpu"),
                              growth=t_growth(**gr_kw, device="cpu"), stream=t_compile_stream(**st_kw, device="cpu"),
                              control=c[1]))
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
    p = pair(pa_graph(n, native=True), msg_slots=8, fanout=2, mode="push_pull", churn_join_prob=0.02,
             rewire_slots=4)
    sc = (j_compile_scenario(j_parse_scenario(path), n_peers=n, n_slots=n, total_rounds=rounds),
          t_compile_scenario(t_parse_scenario(path), n_peers=n, n_slots=n, total_rounds=rounds, device="cpu"))
    st_kw = dict(rate=1.5, msg_slots=8, ttl=ttl, origin_rows=np.arange(n))
    strm = j_compile_stream(**st_kw), t_compile_stream(**st_kw, device="cpu")
    c = controls(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=5, ttl=ttl)
    reports = []
    for ctl in (None, c):
        _, st = run_both(p, rounds, jkw=dict(scenario=sc[0], stream=strm[0], control=ctl and ctl[0]),
                         tkw=dict(scenario=sc[1], stream=strm[1], control=ctl and ctl[1]))
        got = TM.reliability_report(st, target_ratio=0.9, coverage_target=0.95)
        assert got == JM.reliability_report(run_both.jax_stats, target_ratio=0.9, coverage_target=0.95)
        reports.append(got)
    static, controlled = reports
    assert not static["holds"] and static["messages_judged"] == controlled["messages_judged"] > 0
    assert controlled["delivery_ratio"] > static["delivery_ratio"]


def test_byzantine_siege_demonstration_pair():
    """``tests/sim/test_adversary.py``'s demonstration pair under
    ``scenarios/byzantine_siege.toml`` with a stream and the controller:
    quorum 1 evicts healthy peers and misses the 0.9 target, quorum 3
    holds it with eviction precision >= 0.95 and quarantines accusers;
    every run and report equal to JAX's."""
    path = "scenarios/byzantine_siege.toml"
    n, rounds = 96, 55
    p = pair(pa_graph(n, m=2, native=True), msg_slots=8, fanout=2, mode="push_pull", rewire_slots=6,
             churn_join_prob=0.02)
    jspec, tspec = j_parse_scenario(path), t_parse_scenario(path)
    jspec.validate(total_rounds=rounds, n_peers=n)
    sc = (j_compile_scenario(jspec, n_peers=n, n_slots=n, total_rounds=rounds),
          t_compile_scenario(tspec, n_peers=n, n_slots=n, total_rounds=rounds, device="cpu"))
    st_kw = dict(rate=1.5, msg_slots=8, ttl=24, origin_rows=np.arange(n))
    strm = j_compile_stream(**st_kw), t_compile_stream(**st_kw, device="cpu")
    c = controls(target_ratio=0.9, fanout=2, lo=1, hi=6, refresh_every=5, ttl=24)
    out = {}
    for k in (1, 3):
        _, st = run_both(p, rounds,
                         jkw=dict(scenario=sc[0], stream=strm[0], control=c[0],
                                  liveness=jl.compile_quorum(k, window=4, budget=2)),
                         tkw=dict(scenario=sc[1], stream=strm[1], control=c[1],
                                  liveness=tl.compile_quorum(k, window=4, budget=2)))
        out[k] = (TM.reliability_report(st, target_ratio=0.9, coverage_target=0.95), TM.liveness_report(st))
    (rel1, lv1), (rel3, lv3) = out[1], out[3]
    assert rel1["delivery_ratio"] < 0.9 and not rel1["holds"]
    assert lv1["eviction_precision"] < 0.95 and lv1["false_evictions"] > 20
    assert rel3["delivery_ratio"] >= 0.9 and rel3["holds"]
    assert lv3["eviction_precision"] >= 0.95 and lv3["quarantined"] > 0
