"""The packed-native round against the JAX package's packed round and the
port's own unpacked round, bit for bit: state and stats digests after
``simulate(20)`` over the matching plan, the exactly-k CSR path (the
word-native delivery) and the staircase kernel path, and equal
``run_until_coverage`` round counts."""

import jax
import numpy as np
import pytest

from tpu_gossip.core.packed import pack_state as jpack
from tpu_gossip.core.packed import unpack_state as junpack
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim.engine import run_until_coverage as jrun
from tpu_gossip.sim.engine import simulate as jsim
from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
from tpu_gossip_torch.sim.engine import run_until_coverage as trun
from tpu_gossip_torch.sim.engine import simulate as tsim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread, build_both  # noqa: F401
from tests.test_torch_staircase import build_both_csr

# name: (graph, cfg keywords, tail)
RUNS = {
    "matching_push_pull_f1": ("matching", dict(mode="push_pull", fanout=1), "fused"),
    "xla_push_pull_f1": ("xla", dict(mode="push_pull", fanout=1), "fused"),
    "xla_push_f3": ("xla", dict(mode="push", fanout=3), "fused"),
    "xla_flood": ("xla", dict(mode="flood"), "fused"),
    "staircase_push_pull_f1": ("staircase", dict(mode="push_pull", fanout=1), "fused"),
    "xla_sir4_tail_pallas": ("xla", dict(mode="push_pull", fanout=1, sir_recover_rounds=4), "pallas"),
    "matching_forward_once": ("matching", dict(mode="push_pull", fanout=1, forward_once=True), "fused"),
}


def _build(graph, seed, **cfg_kw):
    if graph == "matching":
        return build_both(2000, seed=seed, **cfg_kw)
    return build_both_csr(2000, seed=seed, staircase=graph == "staircase", **cfg_kw)


@pytest.mark.parametrize("name", list(RUNS))
def test_packed_simulate_equals_jax_packed_and_port_unpacked(name):
    graph, cfg_kw, tail = RUNS[name]
    (jc, js, jp), (tc, ts, tp) = _build(graph, 1, **cfg_kw)
    tf_u, tst_u = tsim(ts, tc, 20, tp, tail)
    tf_p, tst_p = tsim(pack_state(ts), tc, 20, tp, tail)
    jf_p, jst_p = jsim(jpack(js), jc, 20, jp, tail)
    assert isinstance(tf_p, PackedSwarm) and tf_p.msg_slots == 16
    assert t_state_digest(tf_p) == j_state_digest(jf_p)
    assert t_state_digest(unpack_state(tf_p)) == j_state_digest(junpack(jf_p)) == t_state_digest(tf_u)
    assert t_stats_digest(tst_p) == j_stats_digest(jst_p) == t_stats_digest(tst_u)
    np.testing.assert_array_equal(tst_p.coverage.numpy(), np.asarray(jst_p.coverage))
    np.testing.assert_array_equal(tst_p.coverage.numpy(), tst_u.coverage.numpy())
    assert int(tst_p.msgs_sent.sum()) > 0


@pytest.mark.parametrize("graph", ["matching", "xla"])
def test_packed_run_until_coverage_rounds_equal(graph):
    (jc, js, jp), (tc, ts, tp) = _build(graph, 2, mode="push_pull", fanout=1)
    tf_u = trun(ts, tc, 0.99, 1000, plan=tp)
    tf_p = trun(pack_state(ts), tc, 0.99, 1000, plan=tp)
    jf_p = jrun(jpack(js), jc, 0.99, 1000, plan=jp)
    assert isinstance(tf_p, PackedSwarm)
    assert int(tf_p.round) == int(jf_p.round) == int(tf_u.round) > 0
    assert t_state_digest(tf_p) == j_state_digest(jf_p)
    assert t_state_digest(unpack_state(tf_p)) == t_state_digest(tf_u)
    assert float(tf_p.coverage(0)) == float(np.asarray(jax.device_get(jf_p.coverage(0))))


def test_packed_round_refuses_later_slices():
    from tpu_gossip_torch.sim.engine import gossip_round

    (_, _, _), (tc, ts, tp) = build_both(500, seed=0, mode="push_pull", fanout=1)
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict

    # a scenario's admission waves run (growth); a live-ingestion batch is
    # the serving slice's
    waves = compile_scenario(scenario_from_dict({"phases": [{"start": 0, "end": 2, "join_burst": 3}]}), n_peers=500,
                             n_slots=ts.seen.shape[0], total_rounds=4, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        gossip_round(pack_state(ts), tc, tp, scenario=waves, inject=object())
    with pytest.raises(TypeError):
        gossip_round(pack_state(ts), tc, tp, bogus=1)
    with pytest.raises(ValueError):
        gossip_round(pack_state(ts), tc, tp, tail="bogus")
