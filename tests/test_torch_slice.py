"""The slice as a whole: the port's rounds equal the JAX package's bit for
bit, through state_digest/stats_digest (tpu_gossip/fleet/engine.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_gossip.core.matching_topology import matching_powerlaw_graph as jbuild
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as jinit
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim.engine import run_until_coverage as jrun
from tpu_gossip.sim.engine import simulate as jsim
from tpu_gossip_torch import convert
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph as tbuild
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as tinit
from tpu_gossip_torch.sim.engine import run_until_coverage as trun
from tpu_gossip_torch.sim.engine import simulate as tsim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker, so the suite's wall-clock tests in
    the other workers keep their cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADLINE = dict(mode="push_pull", fanout=1)


def build_both(n, seed=0, **cfg_kw):
    """The same swarm built by both packages: (jax cfg, state, plan), (port ...)."""
    kw = dict(n_peers=n + 1, msg_slots=16, **cfg_kw)
    fan = None if kw.get("mode") == "flood" else kw.get("fanout", 3)
    origins = np.random.default_rng(seed).choice(n, size=1, replace=False)
    jg, jp = jbuild(n, fanout=fan, key=jax.random.key(seed))
    js = jinit(jg.as_padded_graph(), JConfig(**kw), key=jax.random.key(seed), origins=origins,
               exists=jg.exists)
    tg, tp = tbuild(n, fanout=fan, key=prng.key(seed, "cpu"), device="cpu")
    ts = tinit(tg.as_padded_graph(), TConfig(**kw), key=prng.key(seed, "cpu"), origins=origins,
               exists=tg.exists, device="cpu")
    return (JConfig(**kw), js, jp), (TConfig(**kw), ts, tp)


def assert_same_run(j, t, rounds):
    (jc, js, jp), (tc, ts, tp) = j, t
    jf, jst = jsim(js, jc, rounds, jp)
    tf, tst = tsim(ts, tc, rounds, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    # coverage is a float32 ratio of integer counts on both sides
    np.testing.assert_array_equal(np.asarray(jst.coverage), tst.coverage.numpy())
    return tf, tst


@pytest.mark.parametrize("n", [2000, 20000])
def test_headline_simulate_digests_equal_jax(n):
    _, tst = assert_same_run(*build_both(n, **HEADLINE), rounds=20)
    assert float(tst.coverage[-1]) > 0.99


def test_initial_state_digest_equals_jax():
    (_, js, _), (_, ts, _) = build_both(2000, seed=4, **HEADLINE)
    assert t_state_digest(ts) == j_state_digest(js)


def test_run_until_coverage_rounds_equal_jax():
    (jc, js, jp), (tc, ts, tp) = build_both(2000, **HEADLINE)
    jf = jrun(js, jc, 0.99, 1000, plan=jp)
    tf = trun(ts, tc, 0.99, 1000, plan=tp)
    assert int(tf.round) == int(jf.round) > 0
    assert t_state_digest(tf) == j_state_digest(jf)


def test_round_on_jax_seeded_state_and_plan():
    """A state and plan the JAX package built, carried across, run in the port."""
    (jc, js, jp), (tc, _, _) = build_both(2000, seed=2, **HEADLINE)
    leaves = {f.name: np.asarray(jax.random.key_data(js.rng) if f.name == "rng" else getattr(js, f.name))
              for f in dataclasses.fields(js)}
    ts = convert.state_from_jax(leaves, device="cpu")
    assert t_state_digest(ts) == j_state_digest(js)
    pleaves = {k: [np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)
               for k, v in ((name, getattr(jp, name)) for name in convert.PLAN_LEAVES)}
    tp = convert.plan_from_jax(pleaves, {k: getattr(jp, k) for k in convert.PLAN_STATIC}, device="cpu")
    tf, _ = tsim(ts, tc, 6, tp)
    jf, _ = jsim(js, jc, 6, jp)
    assert t_state_digest(tf) == j_state_digest(jf)
    back = convert.to_numpy(tf)
    np.testing.assert_array_equal(back["rng"], np.asarray(jax.random.key_data(jf.rng)))
    assert back["round"].dtype == np.int32 and back["round"].shape == ()
