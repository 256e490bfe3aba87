"""The sharded matching engine against the JAX package's mesh runs pinned
in ``tests/jax_pins.json`` (``test_torch_mesh_pins.py`` recomputes them
with JAX in child processes): the mesh round at S = 2, 4 and 8, push,
push_pull and flood, the sparse and auto transports and the packed twin,
each with the ICI counters' totals; the distributed builder's run; and one
witness a plane at S = 4 (churn with re-wiring, the chaos scenario, a
siege under the quorum detector, growth, a stream, the controller, a
depth-1 pipeline), each also held to the port's local round on the same
plan and planes."""

import pytest

from tests.jax_pins import CASES, pinned
from tests.test_torch_mesh import mesh_run
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ROUNDS = ["s2", "s4", "s8", "s8_push", "s8_flood", "s8_sparse", "s4_auto", "s8_packed_sparse", "s8_dist"]
PLANES = ["churn", "scenario", "quorum", "growth", "stream", "control", "pipeline"]


def case_run(name: str, local: bool = False) -> dict:
    n, s, mode, rounds, transport, packed, plane, pipeline, builder, ici = CASES["mesh"][name][1]
    return mesh_run(n, s, mode, rounds, transport, packed, plane, pipeline, builder, ici and not local, local)


@pytest.mark.parametrize("name", ROUNDS)
def test_mesh_run_equals_jax_mesh(name):
    """Digests and ICI totals equal the JAX mesh's; the digests equal the
    port's local round on the same plan."""
    got = case_run(name)
    assert got == pinned("mesh", name)
    want_local = case_run(name, local=True)
    assert {k: got[k] for k in want_local} == want_local


@pytest.mark.parametrize("plane", PLANES)
def test_plane_on_the_mesh_equals_jax_and_local(plane):
    name = f"s4_{plane}"
    got = case_run(name)
    assert got == pinned("mesh", name)
    assert case_run(name, local=True) == got


def test_pins_of_twins_agree():
    """The JAX mesh's twins agree among their pins: the packed run is the
    unpacked sparse run (digests and counters), auto's trajectory is
    dense's."""
    assert pinned("mesh", "s8_packed_sparse") == pinned("mesh", "s8_sparse")
    keys = ("state_digest", "stats_digest")
    assert {k: pinned("mesh", "s4_auto")[k] for k in keys} == {k: pinned("mesh", "s4")[k] for k in keys}
