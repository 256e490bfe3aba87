"""The local half of ``tests/sim/test_traffic.py``'s acceptance cell,
``test_matching_stream_local_vs_sharded_bit_identical``, on the CPU: a
loaded run on the S=8 matching layout with growth rows, in push-pull and
flood with the hotspot law, under the chaos scenario and while a flash
crowd joins, equal to JAX's local run of the same cell
(:func:`jax_matching_stream`, pinned in ``tests/jax_pins.json``, group
``stream_matching``; ``test_stream_matching_pins_are_current`` recomputes
one cell in a child process), and its sharded half: the same run on the
8-shard matching mesh equals the local one."""

import jax
import numpy as np
import pytest

from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.jax_pins import STREAM_MATCHING, field_digest, pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream import _np


STREAM_STATE_FIELDS = ("seen", "exists", "alive", "rewired", "declared_dead", "recovered", "last_hb",
                       "rewire_targets", "fault_held", "slot_lease", "join_round", "admitted_by", "degree_credit")


def _matching_rows(plan, ids):
    ids = np.asarray(ids)
    return (ids // plan.n_per) * plan.n_blk + (ids % plan.n_per)


CHAOS = {"name": "chaos", "phases": [
    {"name": "lossy", "start": 0, "end": 2, "loss": 0.3, "delay": 0.3},
    {"name": "split", "start": 2, "end": 4, "partition": "half", "loss": 0.1},
    {"name": "storm", "start": 4, "end": 6, "churn_leave": 0.1, "churn_join": 0.3,
     "blackout": {"frac": 0.1, "seed": 9}}]}


def _cell(compose, mode):
    """The cell's config kwargs (growth rows re-wire; the scenario churns)."""
    extra = dict(rewire_slots=2) if compose == "growth" else {}
    if compose == "scenario":
        extra = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=2)
    return dict(msg_slots=8, fanout=2, mode=mode, **extra)


def jax_matching_stream(mode: str, law: str, compose) -> dict:
    """The JAX half of :func:`test_matching_stream_on_the_sharded_layout_equals_jax_local`:
    its run's digests and the stream state planes as lists."""
    from tpu_gossip import faults as jf
    from tpu_gossip import growth as jg
    from tpu_gossip import traffic as jt
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded as jb

    jgraph, jplan = jb(800, 8, fanout=2, key=jax.random.key(0), growth_rows=32)
    kw = dict(n_peers=jplan.n, **_cell(compose, mode))
    js = j_init(jgraph.as_padded_graph(), JConfig(**kw), origins=[0, 5], exists=jgraph.exists, key=jax.random.key(3))
    jstrm = jt.compile_stream(rate=4.0, msg_slots=8, ttl=7, origin_rows=_matching_rows(jplan, np.arange(800)),
                              origins=law, burst_every=3)
    jsc = jgp = None
    if compose == "scenario":
        jsc = jf.compile_scenario(jf.scenario_from_dict(CHAOS), n_peers=800, n_slots=jplan.n, total_rounds=10,
                                  node_map=lambda ids: _matching_rows(jplan, ids))
    elif compose == "growth":
        jgp = jg.compile_growth(n_initial=800, target=900, n_slots=jplan.n, joins_per_round=16, attach_m=2,
                                admit_rows=jg.matching_admit_rows(jplan, 100))
    jfin, jst = je.simulate(js, JConfig(**kw), 10, jplan, "fused", jsc, jgp, jstrm)
    return dict(state=j_state_digest(jfin), stats=j_stats_digest(jst),
                fields={f: np.asarray(getattr(jfin, f)).tolist() for f in STREAM_STATE_FIELDS})


@pytest.mark.parametrize("mode,law,compose", list(STREAM_MATCHING.values()), ids=list(STREAM_MATCHING))
def test_matching_stream_on_the_sharded_layout_equals_jax_local(mode, law, compose):
    """The local half of test_matching_stream_local_vs_sharded_bit_identical:
    a loaded run (rate 4, bursts every 3 rounds, TTL 7) on the S=8
    matching layout with 32 growth rows a block, under the chaos scenario
    or a flash crowd, equal to JAX's local run (pinned), the load biting.
    The sharded half: the same run on the 8-shard matching mesh equals the
    local one."""
    from tpu_gossip_torch import faults as tf
    from tpu_gossip_torch import growth as tg
    from tpu_gossip_torch import traffic as tt
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded as tb

    tgraph, tplan = tb(800, 8, fanout=2, key=prng.key(0, "cpu"), growth_rows=32, device="cpu")
    kw = dict(n_peers=tplan.n, **_cell(compose, mode))
    ts = t_init(tgraph.as_padded_graph(), TConfig(**kw), origins=[0, 5], exists=tgraph.exists,
                key=prng.key(3, "cpu"), device="cpu")
    tstrm = tt.compile_stream(rate=4.0, msg_slots=8, ttl=7, origin_rows=_matching_rows(tplan, np.arange(800)),
                              origins=law, burst_every=3, device="cpu")
    tsc = tgp = None
    if compose == "scenario":
        tsc = tf.compile_scenario(tf.scenario_from_dict(CHAOS), n_peers=800, n_slots=tplan.n, total_rounds=10,
                                  node_map=lambda ids: _matching_rows(tplan, ids), device="cpu")
    elif compose == "growth":
        tgp = tg.compile_growth(n_initial=800, target=900, n_slots=tplan.n, joins_per_round=16, attach_m=2,
                                admit_rows=tg.matching_admit_rows(tplan, 100), device="cpu")
    name = [k for k, v in STREAM_MATCHING.items() if v == (mode, law, compose)][0]
    want = pinned("stream_matching", name)
    tfin, tst = te.simulate(ts, TConfig(**kw), 10, tplan, "fused", scenario=tsc, growth=tgp, stream=tstrm)
    assert t_state_digest(tfin) == want["state"] and t_stats_digest(tst) == want["stats"]
    for f in STREAM_STATE_FIELDS:
        assert field_digest(_np(getattr(tfin, f))) == want["fields"][f], f
    assert int(tst.stream_injected.sum()) > 10 and int(tst.stream_expired.sum()) > 0
    if compose == "scenario":
        assert int(tst.msgs_dropped.sum()) > 0
    if compose == "growth":
        assert int(tst.n_members[-1]) == 900
    from tpu_gossip_torch import dist as tdist

    mesh = tdist.make_mesh(8, device="cpu")
    mfin, mst = tdist.simulate_dist(tdist.shard_swarm(ts, mesh), TConfig(**kw), tdist.shard_matching_plan(tplan, mesh),
                                    mesh, 10, scenario=tsc, growth=tgp, stream=tstrm)
    assert t_state_digest(mfin) == want["state"] and t_stats_digest(mst) == want["stats"]


def test_stream_matching_pins_are_current():
    """One cell's pin, recomputed by the JAX package in a child process (a
    test worker's XLA CPU compiler has died under the suite's load), equals
    the file."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    assert jax_in_child("tests.jax_pins", "compute", "stream_matching", ["flood_hotspot"]) == {
        "flood_hotspot": pinned("stream_matching", "flood_hotspot")}
