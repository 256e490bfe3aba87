"""The slice as a whole: the port's rounds equal the JAX package's bit for
bit, through state_digest/stats_digest (tpu_gossip/fleet/engine.py)."""

import fcntl
import subprocess
import tempfile
from pathlib import Path

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


def ensure_jax_native_pa() -> None:
    """Build the JAX package's C++ preferential-attachment library when it
    is missing, as ``tests/unit/test_native.py`` builds it, one process at a
    time (a file lock). The JAX package's ``--graph pa`` draws with it when
    it exists and with a numpy generator otherwise, while the port always
    runs its copy of the C++ one, so a comparison made before any test has
    built the library would hold the port to the other generator. A host
    without the toolchain keeps the fallback (the comparisons that need the
    library skip there)."""
    import tpu_gossip.native as native

    if native._load() is not None:
        return
    with open(Path(tempfile.gettempdir()) / "tpu_gossip_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._lib = None
        if native._load() is None:
            try:
                subprocess.run(["make", "-C", str(Path(native.__file__).parent)], check=True, capture_output=True,
                               timeout=120)
            except (OSError, subprocess.SubprocessError):
                return
            native._lib = None
            native._load()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker, so the suite's wall-clock tests in
    the other workers keep their cores (restored after the module); and the
    JAX package's native PA library built before the module's comparisons
    (:func:`ensure_jax_native_pa`), whatever order the tests run in."""
    ensure_jax_native_pa()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADLINE = dict(mode="push_pull", fanout=1)


def _swarm_args(n, seed, cfg_kw):
    kw = dict(n_peers=n + 1, msg_slots=16, **cfg_kw)
    fan = None if kw.get("mode") == "flood" else kw.get("fanout", 3)
    return kw, fan, np.random.default_rng(seed).choice(n, size=1, replace=False)


def build_jax(n, seed=0, **cfg_kw):
    """The JAX package's matching swarm: (cfg, state, plan)."""
    kw, fan, origins = _swarm_args(n, seed, cfg_kw)
    jg, jp = jbuild(n, fanout=fan, key=jax.random.key(seed))
    js = jinit(jg.as_padded_graph(), JConfig(**kw), key=jax.random.key(seed), origins=origins,
               exists=jg.exists)
    return JConfig(**kw), js, jp


def build_port(n, seed=0, **cfg_kw):
    """The same swarm built by the port, on the CPU: (cfg, state, plan)."""
    kw, fan, origins = _swarm_args(n, seed, cfg_kw)
    tg, tp = tbuild(n, fanout=fan, key=prng.key(seed, "cpu"), device="cpu")
    ts = tinit(tg.as_padded_graph(), TConfig(**kw), key=prng.key(seed, "cpu"), origins=origins,
               exists=tg.exists, device="cpu")
    return TConfig(**kw), ts, tp


def build_both(n, seed=0, **cfg_kw):
    """The same swarm built by both packages: (jax cfg, state, plan), (port ...)."""
    return build_jax(n, seed, **cfg_kw), build_port(n, seed, **cfg_kw)


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
    """A state and plan the JAX package built, carried across, run in the
    port. The JAX half runs in a child process (``jax_in_child``): its
    in-process compile has lost a test worker to XLA's CPU compiler under
    the suite's load."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    def arr(leaf):
        return [arr(x) for x in leaf] if isinstance(leaf, list) else np.asarray(leaf["data"], dtype=leaf["dtype"])

    want = jax_in_child("tests.jax_pins", "seeded_matching_run", 2000, 2, 6)
    (tc, _, _) = build_port(2000, seed=2, **HEADLINE)
    ts = convert.state_from_jax({k: arr(v) for k, v in want["state"].items()}, device="cpu")
    assert t_state_digest(ts) == want["state_digest"]
    tp = convert.plan_from_jax({k: arr(v) for k, v in want["plan"].items()}, want["static"], device="cpu")
    tf, _ = tsim(ts, tc, 6, tp)
    assert t_state_digest(tf) == want["final_digest"]
    back = convert.to_numpy(tf)
    np.testing.assert_array_equal(back["rng"], np.asarray(want["final_rng"], dtype=np.uint32))
    assert back["round"].dtype == np.int32 and back["round"].shape == ()