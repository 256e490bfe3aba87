"""The tpu-sim transport in the port (``tpu_gossip_torch/compat/simnet.py``)
on the CPU: the cases of ``tests/compat/test_simnet.py`` on the port's
``PeerNode`` and ``SimCluster``, scripted runs (one message, several,
``dedup_hashes=3``, silent peers before and after ``materialize``, kills,
``materialize(graph=)``, config keywords) held to the JAX package's digests,
coverages and verdicts pinned in ``tests/jax_pins.json`` (group ``simnet``,
rechecked in a child process here), value semantics (a state taken
before ``gossip``, ``set_silent``, ``kill`` or ``step`` stays as it was), the
errors in JAX's words and the card default. No JAX program is compiled in
this process."""

import dataclasses

import numpy as np
import pytest
import torch

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.compat.simnet import SimCluster as JaxCluster
from tpu_gossip_torch.compat.peer import PeerNode
from tpu_gossip_torch.compat.simnet import SimCluster
from tpu_gossip_torch.core.state import SwarmState
from tpu_gossip_torch.core.topology import build_csr, preferential_attachment


def make_cluster(n=64, **kw):
    cluster = SimCluster(msg_slots=16, fanout=3, seed=0, device="cpu", **kw)
    peers = [PeerNode("10.0.0.1", 9000 + i, transport="tpu-sim", cluster=cluster) for i in range(n)]
    cluster.materialize(m=3)
    return cluster, peers


# --- tests/compat/test_simnet.py on the port -------------------------------


def test_requires_cluster():
    with pytest.raises(ValueError):
        PeerNode("127.0.0.1", 1, transport="tpu-sim")


def test_gossip_reaches_everyone():
    cluster, peers = make_cluster(64)
    peers[0].gossip("hello")
    assert peers[0].has_seen("hello")
    cluster.step(25)
    assert cluster.coverage("hello") >= 0.99
    assert all(p.has_seen("hello") for p in peers)


def test_multiple_messages_dedup_slots():
    cluster, peers = make_cluster(64)
    peers[0].gossip("msg-a")
    peers[10].gossip("msg-b")
    cluster.step(30)
    assert cluster.coverage("msg-a") >= 0.99
    assert cluster.coverage("msg-b") >= 0.99


def test_silent_peer_declared_dead():
    cluster, peers = make_cluster(64)
    peers[5].set_silent(True)
    cluster.step(12)  # timeout 6 rounds + sweep 2 -> declared by round 8
    assert cluster.is_declared_dead(peers[5].addr)
    assert not cluster.is_declared_dead(peers[6].addr)


def test_neighbors_power_law():
    cluster, peers = make_cluster(128)
    degs = sorted(len(p.neighbors) for p in peers)
    assert degs[0] >= 3  # PA guarantees m edges per node
    assert degs[-1] > 3 * degs[len(degs) // 2]  # hubs exist


def test_register_after_materialize_rejected():
    cluster, peers = make_cluster(16)
    with pytest.raises(RuntimeError, match="cluster already materialized; register first"):
        cluster.register_peer(("10.9.9.9", 1))


# --- scripted runs against the JAX package ---------------------------------


@pytest.mark.parametrize("name", list(jax_pins.SIMNET_SCRIPTS))
def test_scripted_run_equals_jax(name):
    """Every step's state and stats digests, each message's coverage (exact),
    ``has_seen`` at three peers and every peer's ``is_declared_dead`` equal
    the JAX package's run of the same script."""
    got = jax_pins.simnet_script("torch", name)
    want = jax_pins.pinned("simnet", name)
    assert got["steps"] == want["steps"]
    assert got["coverage"] == want["coverage"]
    assert got["has_seen"] == want["has_seen"]
    assert got["declared_dead"] == want["declared_dead"]


def test_simnet_pins_are_current():
    """One script of the ``simnet`` group recomputed by the JAX package in a
    child process."""
    name = "silent_before_and_after"
    assert jax_in_child("tests.jax_pins", "compute", "simnet", [name]) == {name: jax_pins.pinned("simnet", name)}


def test_bloom_coverage_is_the_all_planes_fraction():
    """With k > 1 a peer counts as covered when all its planes are set, over
    the live peers (JAX's formula, float32)."""
    cluster = SimCluster(msg_slots=32, fanout=3, seed=1, dedup_hashes=3, device="cpu")
    peers = [PeerNode(*jax_pins.simnet_addr(i), transport="tpu-sim", cluster=cluster) for i in range(300)]
    cluster.materialize(m=3)
    peers[0].gossip("alpha")
    cluster.step(3)
    cluster.kill(peers[1].addr)
    cluster.step(1)
    st = cluster.state
    slots = list(cluster._slots("alpha"))
    assert len(slots) == 3
    live = st.alive & ~st.declared_dead
    got = (st.seen[:, slots].all(dim=1) & live).sum().item()
    want = torch.tensor(got, dtype=torch.float32) / torch.tensor(max(live.sum().item(), 1), dtype=torch.float32)
    assert cluster.coverage("alpha") == float(want)
    assert 0 < cluster.coverage("alpha") < 1


# --- value semantics ---------------------------------------------------------


def _snapshot(state: SwarmState) -> dict:
    return {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(SwarmState)}


@pytest.mark.parametrize("op", ["gossip", "gossip_again", "set_silent", "kill", "step"])
def test_state_taken_before_an_op_is_unchanged(op):
    """Each op installs a new state and writes no plane of the old one in
    place, though the round shares planes between states."""
    cluster, peers = make_cluster(80)
    peers[0].gossip("first")
    cluster.step(2)
    held = cluster.state
    before = _snapshot(held)
    if op == "gossip":
        peers[40].gossip("second")
    elif op == "gossip_again":
        peers[0].gossip("first")
    elif op == "set_silent":
        peers[3].set_silent(True)
    elif op == "kill":
        cluster.kill(peers[4].addr)
    else:
        cluster.step(3)
    assert cluster.state is not held
    for name, plane in before.items():
        assert torch.equal(getattr(held, name), plane), name
    changed = [n for n, plane in before.items() if not torch.equal(getattr(cluster.state, n), plane)]
    # a message gossiped again by a peer that has it changes no plane
    assert bool(changed) == (op != "gossip_again"), changed


def test_regossip_keeps_the_first_infection_round():
    """A message gossiped again keeps its first-infection round (the
    ``infected_round < 0`` gate, on the device)."""
    cluster, peers = make_cluster(400)
    peers[0].gossip("m")
    cluster.step(2)
    slot = cluster._slots("m")[0]
    fresh = int((~cluster.state.seen[:, slot]).nonzero()[0])
    peers[0].gossip("m")
    peers[fresh].gossip("m")
    st = cluster.state
    assert int(st.infected_round[0, slot]) == 0
    assert int(st.infected_round[fresh, slot]) == 2 == int(st.round)


# --- errors, in JAX's words ---------------------------------------------------


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["dedup", "duplicate", "too_few", "graph_size", "gossip_first", "neighbors_first",
                                  "coverage_first", "step_first"])
def test_errors_match_jax(case):
    """Each refusal the port raises before ``materialize`` builds anything
    has the JAX package's type and words."""
    def run(cls, extra):
        if case == "dedup":
            return _message(lambda: cls(dedup_hashes=0, **extra))
        c = cls(msg_slots=8, **extra)
        for i in range(4):
            c.register_peer(("10.0.0.1", 9000 + i))
        if case == "duplicate":
            return _message(lambda: c.register_peer(("10.0.0.1", 9001)))
        if case == "too_few":
            return _message(lambda: c.materialize(m=3))
        if case == "graph_size":
            g = build_csr(5, preferential_attachment(5, m=2, use_native=False, rng=np.random.default_rng(0)))
            return _message(lambda: c.materialize(graph=g))
        if case == "gossip_first":
            return _message(lambda: c.gossip(("10.0.0.1", 9000), "x"))
        if case == "neighbors_first":
            return _message(lambda: c.neighbors(("10.0.0.1", 9000)))
        if case == "coverage_first":
            return _message(lambda: c.coverage("x"))
        return _message(lambda: c.step(1))

    assert run(SimCluster, {"device": "cpu"}) == run(JaxCluster, {})


def test_silent_pending_before_materialize():
    """``set_silent`` before ``materialize`` is held and applied by it
    (``set_silent(False)`` takes a pending peer back out)."""
    cluster = SimCluster(msg_slots=8, device="cpu")
    peers = [PeerNode("10.0.0.2", 9000 + i, transport="tpu-sim", cluster=cluster) for i in range(20)]
    peers[3].set_silent(True)
    peers[4].set_silent(True)
    peers[4].set_silent(False)
    assert cluster.state is None
    cluster.materialize(m=2)
    assert cluster.state.silent.nonzero().flatten().tolist() == [3]


def test_device_is_not_a_config_keyword():
    """``device`` stays the cluster's; the other keywords reach
    ``SwarmConfig``, an unknown one refused there as in JAX."""
    cluster = SimCluster(msg_slots=8, timeout_rounds=4, device="cpu")
    for i in range(10):
        cluster.register_peer(("10.0.0.3", i))
    cluster.materialize(m=2)
    assert cluster.cfg.timeout_rounds == 4 and cluster.state.seen.device.type == "cpu"
    bad = SimCluster(msg_slots=8, device="cpu", no_such_knob=1)
    for i in range(10):
        bad.register_peer(("10.0.0.3", i))
    with pytest.raises(TypeError):
        bad.materialize(m=2)


def test_runs_on_the_card_by_default(monkeypatch):
    """``SimCluster()`` asks for the card; without one it raises and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimCluster()
    with pytest.raises(RuntimeError, match="CUDA"):
        SimCluster(device="cuda")


def test_compat_package_does_not_import_simnet():
    """``tpu_gossip_torch.compat`` exports the socket nodes without
    importing ``simnet``, as the JAX package's ``compat`` does, and the
    socket path (the nodes and their CLIs) imports no torch at all."""
    import subprocess
    import sys

    code = ("import sys, tpu_gossip_torch.compat as c, tpu_gossip_torch.cli.run_seed, tpu_gossip_torch.cli.run_peer\n"
            "print(sorted(c.__all__), 'tpu_gossip_torch.compat.simnet' in sys.modules, 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(jax_pins.PINS_FILE.parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['PeerNode',", "'ProtocolTiming',", "'SeedNode']", "False", "False"]
