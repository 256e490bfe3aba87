"""The packed-native round against the JAX package's packed round and the
port's own unpacked round, bit for bit: state and stats digests after
``simulate(20)`` over the matching plan, the exactly-k CSR path (the
word-native delivery) and the staircase kernel path, and equal
``run_until_coverage`` round counts. The JAX runs are pinned in
``tests/jax_pins.json`` (group ``packed_engine``, made by
``tests/jax_pins.py::packed_simulate`` and ``packed_coverage``), one of
them recomputed in a child process; no JAX program is compiled in a test
worker's own process."""

import numpy as np
import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread, build_port  # noqa: F401
from tests.test_torch_staircase import build_port_csr
from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
from tpu_gossip_torch.sim.engine import run_until_coverage as trun
from tpu_gossip_torch.sim.engine import simulate as tsim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest

RUNS = jax_pins.PACKED_RUNS  # name: (graph, cfg keywords, tail)


def _build(graph, seed, **cfg_kw):
    """The port's half of ``tests/jax_pins.py::_jax_packed_swarm``: the
    n=2000 matching swarm, or the Chung-Lu one with its staircase plan."""
    if graph == "matching":
        return build_port(2000, seed=seed, **cfg_kw)
    return build_port_csr(2000, seed=seed, staircase=graph == "staircase", **cfg_kw)


@pytest.mark.parametrize("name", list(RUNS))
def test_packed_simulate_equals_jax_packed_and_port_unpacked(name):
    graph, cfg_kw, tail = RUNS[name]
    want = jax_pins.pinned("packed_engine", name)
    tc, ts, tp = _build(graph, 1, **cfg_kw)
    tf_u, tst_u = tsim(ts, tc, 20, tp, tail)
    tf_p, tst_p = tsim(pack_state(ts), tc, 20, tp, tail)
    assert isinstance(tf_p, PackedSwarm) and tf_p.msg_slots == 16
    assert t_state_digest(tf_p) == want["state_digest"]
    assert t_state_digest(unpack_state(tf_p)) == want["unpacked_digest"] == t_state_digest(tf_u)
    assert t_stats_digest(tst_p) == want["stats_digest"] == t_stats_digest(tst_u)
    np.testing.assert_array_equal(tst_p.coverage.numpy(), np.asarray(want["coverage"], dtype=np.float32))
    np.testing.assert_array_equal(tst_p.coverage.numpy(), tst_u.coverage.numpy())
    assert int(tst_p.msgs_sent.sum()) > 0


@pytest.mark.parametrize("graph", ["matching", "xla"])
def test_packed_run_until_coverage_rounds_equal(graph):
    want = jax_pins.pinned("packed_engine", f"coverage_{graph}")
    tc, ts, tp = _build(graph, 2, mode="push_pull", fanout=1)
    tf_u = trun(ts, tc, 0.99, 1000, plan=tp)
    tf_p = trun(pack_state(ts), tc, 0.99, 1000, plan=tp)
    assert isinstance(tf_p, PackedSwarm)
    assert int(tf_p.round) == want["round"] == int(tf_u.round) > 0
    assert t_state_digest(tf_p) == want["state_digest"]
    assert t_state_digest(unpack_state(tf_p)) == t_state_digest(tf_u)
    assert float(tf_p.coverage(0)) == want["coverage"]


def test_jax_pins_are_current():
    """One run of the group recomputed by the JAX package in a child
    process."""
    name = "xla_sir4_tail_pallas"
    assert jax_in_child("tests.jax_pins", "compute", "packed_engine", [name]) == {
        name: jax_pins.pinned("packed_engine", name)}


def test_packed_round_refuses_later_slices():
    """A scenario's admission waves (growth) under a live-ingestion batch
    (serving, ROADMAP item 12) run on the packed words: the packed round
    equals the unpacked one with the batch landed; a batch of another type,
    an unknown argument and an unknown tail are refused."""
    from tpu_gossip_torch.sim.engine import _stack, gossip_round
    from tpu_gossip_torch.traffic.ingest import IngestPlan, make_batch

    tc, ts, tp = build_port(500, seed=0, mode="push_pull", fanout=1)
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict

    waves = compile_scenario(scenario_from_dict({"phases": [{"start": 0, "end": 2, "join_burst": 3}]}), n_peers=500,
                             n_slots=ts.seen.shape[0], total_rounds=4, device="cpu")
    batch = make_batch(IngestPlan(msg_slots=tc.msg_slots, max_inject=4), [3, 40, 41], [11, 12, 13], overflow=2,
                       device="cpu")
    fb, sb = gossip_round(ts, tc, tp, scenario=waves, inject=batch)
    fp, sp = gossip_round(pack_state(ts), tc, tp, scenario=waves, inject=batch)
    assert t_state_digest(unpack_state(fp)) == t_state_digest(fb)
    assert t_stats_digest(_stack([sp])) == t_stats_digest(_stack([sb]))
    assert [int(sp.ingest_offered), int(sp.ingest_overflow)] == [3, 2] and int(sp.ingest_injected) > 0
    with pytest.raises(TypeError, match="InjectBatch"):
        gossip_round(pack_state(ts), tc, tp, scenario=waves, inject=object())
    with pytest.raises(TypeError):
        gossip_round(pack_state(ts), tc, tp, bogus=1)
    with pytest.raises(ValueError):
        gossip_round(pack_state(ts), tc, tp, tail="bogus")
