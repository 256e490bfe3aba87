"""Conformance of the port's transports on the CPU:
``tests/conformance/test_curves.py``'s 40-peer socket-vs-sim curve (the
port's barrier-stepped socket peers against three of its ``SimCluster``
curves on the same fixed graph) and ``test_sim_curve_deterministic``; the
port's sim curves equal the JAX package's round for round (pinned in
``tests/jax_pins.json``, group ``simnet``); ``tests/conformance/
test_liveness_band.py``'s tier-1 cases (factor 1.0, quorum 2, the band's
tightness) on the port's ``ProtocolTiming`` and ``simulate``, each run's
digests equal to JAX's; and the topology helpers the curves use
(``Graph.degrees``, ``Graph.neighbors``, ``edges_to_adjacency_sets``) and
``coverage_curve``/``run_with_metrics`` against the JAX package's."""

import asyncio
import io
import json

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import rounds_to, socket_curve
from tests import jax_pins
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.core import topology as jtopology
from tpu_gossip_torch.compat.timing import ProtocolTiming
from tpu_gossip_torch.core import topology

N = 40
REFERENCE_BAND_SECONDS = (30.0, 42.0)  # SURVEY §2.5 worst-case detection
CPU = torch.device("cpu")


def fixed_graph(n: int = N):
    return jax_pins.simnet_fixed_graph("torch", n, 42)


def sim_curve(graph, origin: int, rounds: int, seed: int) -> np.ndarray:
    """Per-round coverage of the message on the port's ``SimCluster``."""
    return np.asarray(chip_smoke.sim_curve(CPU, graph, origin, rounds, seed))


# --- tests/conformance/test_curves.py on the port ------------------------------


def test_socket_vs_sim_curves_agree(tmp_path):
    """The port's barrier-stepped socket curve (``chip_smoke.socket_curve``,
    phase 16b's) against three of its ``SimCluster`` curves, with
    ``test_curves.py``'s 40-peer tolerances."""
    graph = fixed_graph()
    origin = int(np.argmax(graph.degrees))
    rounds = 25

    sock = np.asarray(asyncio.run(socket_curve(graph, origin, rounds, tmp_path)))
    sims = [sim_curve(graph, origin, rounds, seed=s) for s in range(3)]

    assert sock[-1] >= 0.99
    assert all(c[-1] >= 0.99 for c in sims)
    sim_r50 = np.median([rounds_to(c, 0.5) for c in sims])
    sim_r99 = np.median([rounds_to(c, 0.99) for c in sims])
    assert abs(rounds_to(sock, 0.5) - sim_r50) <= 3
    assert abs(rounds_to(sock, 0.99) - sim_r99) <= 5
    mid = slice(2, rounds - 5)
    assert np.all(np.diff(sock) >= -1e-9)
    assert np.max(np.abs(sock[mid] - np.mean(sims, axis=0)[mid])) <= 0.35


def test_sim_curve_deterministic():
    graph = fixed_graph()
    a = sim_curve(graph, 0, 10, seed=7)
    b = sim_curve(graph, 0, 10, seed=7)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["curve_40_s0", "curve_40_s1", "curve_40_s2", "curve_40_s7_origin0"])
def test_sim_curves_equal_jax_round_for_round(case):
    """The port's and the JAX package's ``SimCluster`` curves on one fixed
    graph, from the same origin and seed, are equal round for round."""
    graph = fixed_graph()
    origin = 0 if case.endswith("origin0") else int(np.argmax(graph.degrees))
    seed = int(case.split("_s")[1].split("_")[0])
    rounds = 10 if case.endswith("origin0") else 25
    assert sim_curve(graph, origin, rounds, seed).tolist() == jax_pins.pinned("simnet", case)


def test_curve_pins_are_current():
    """One curve and the liveness band's reference run recomputed by the JAX
    package in a child process."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    names = ["curve_40_s1", "liveness_reference"]
    assert jax_in_child("tests.jax_pins", "compute", "simnet", names) == {
        n: jax_pins.pinned("simnet", n) for n in names}


# --- tests/conformance/test_liveness_band.py's tier-1 cases on the port --------


def _band(name: str) -> dict:
    got = jax_pins.liveness_band_run("torch", name)
    assert got == jax_pins.pinned("simnet", f"liveness_{name}")
    assert got["n_declared_dead"][-1] == jax_pins.LIVENESS_SILENT, "detector missed silent peers"
    assert got["declared"] == got["silent"], "a responsive peer was declared dead"
    return got


def _inside_band(detection_round: int) -> None:
    secs = detection_round * ProtocolTiming().gossip_period
    lo, hi = REFERENCE_BAND_SECONDS
    assert lo <= secs <= hi, f"detection at {secs:.0f}s-equivalent left the {lo:.0f}-{hi:.0f}s band"


def test_detection_latency_inside_reference_band():
    got = _band("reference")
    assert tuple(got["consts"].values()) == (3, 6, 2)
    _inside_band(got["detection_round"])


def test_quorum_detection_stays_inside_reference_band():
    """Quorum 2 under the 100x-scaled timing, no adversaries."""
    got = _band("quorum_2")
    assert tuple(got["consts"].values()) == (3, 6, 2)
    _inside_band(got["detection_round"])


def test_band_is_tight_not_vacuous():
    got = _band("slow_timeout")
    assert got["detection_round"] * ProtocolTiming().gossip_period > REFERENCE_BAND_SECONDS[1]


# --- the helpers the curves stand on --------------------------------------------


@pytest.mark.parametrize("n,seed", [(40, 42), (300, 3)])
def test_graph_helpers_equal_jax(n, seed):
    edges = topology.preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(seed))
    jedges = jtopology.preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(seed))
    g, jg = topology.build_csr(n, edges), jtopology.build_csr(n, jedges)
    assert g.degrees.dtype == jg.degrees.dtype and np.array_equal(g.degrees, jg.degrees)
    for i in range(n):
        assert np.array_equal(g.neighbors(i), jg.neighbors(i))
    assert topology.edges_to_adjacency_sets(edges) == jtopology.edges_to_adjacency_sets(jedges)


def test_coverage_curve_and_run_with_metrics():
    """``run_with_metrics`` is ``simulate`` plus one JSON row a round, and
    ``coverage_curve`` the coverage column on the host."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig, clone_state, init_swarm
    from tpu_gossip_torch.sim.engine import simulate
    from tpu_gossip_torch.sim.metrics import coverage_curve, run_with_metrics, stats_rows
    from tpu_gossip_torch.utils.digest import state_digest

    g = fixed_graph(200)
    cfg = SwarmConfig(n_peers=200, msg_slots=4, fanout=2)
    state = init_swarm(g, cfg, origins=[0], key=prng.key(3, "cpu"), device="cpu")
    want_fin, want_stats = simulate(clone_state(state), cfg, 6)
    sink = io.StringIO()
    fin, stats = run_with_metrics(state, cfg, 6, sink)
    assert state_digest(fin) == state_digest(want_fin)
    rows = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert rows == list(stats_rows(want_stats))
    curve = coverage_curve(stats)
    assert isinstance(curve, np.ndarray) and curve.dtype == np.float32
    assert curve.tolist() == [r["coverage"] for r in rows]
    assert run_with_metrics(state, cfg, 2)[1].coverage.shape == (2,)
