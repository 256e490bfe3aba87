"""The JAX results ``tests/jax_pins.json`` pins for the port's sharded
matching tests are what the JAX package computes today: a batch of the
``mesh``, the ``mesh_cli`` and the ``mesh_facts`` cases of
``tests/jax_pins.py::CASES``
recomputed on a mesh of forced host devices in one child process each
(``jax_in_child``, retried once on a compiler signal) and held to the
file (the others: the comment at :data:`BATCHES`)."""

import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401  (builds the JAX package's PA library)

BATCHES = [
    ("mesh", ["s2", "s8_sparse", "s4_scenario"]),
    ("mesh_cli", ["sparse", "small_chung_lu_sparse"]),
    ("mesh_facts", ["tables_s2_sparse_frac8", "totals"]),
]
# A JAX mesh program takes 10-70 s to compile on the forced host devices,
# so the suite rechecks one batch a group (both mesh sizes' extremes, the
# sparse counters, a plane, the CLI's matching and bucketed transports, and
# two of the unit tests' facts); ``python
# -m tests.jax_pins write mesh mesh_cli mesh_facts`` recomputes every pin. The port's tests hold twins among the
# pins too (test_torch_mesh_planes.py::test_pins_of_twins_agree,
# test_torch_mesh_cli.py::test_transports_share_the_trajectory).


@pytest.mark.parametrize("group,names", BATCHES, ids=["-".join(b[1]) for b in BATCHES])
def test_jax_pins_are_current(group, names):
    assert jax_in_child("tests.jax_pins", "compute", group, names) == {
        name: jax_pins.pinned(group, name) for name in names}

