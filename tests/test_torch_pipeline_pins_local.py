"""The JAX results ``tests/jax_pins.json`` pins for the port's
pipelined-round tests on the local engine are what the JAX package
computes today: each batch of cases of ``tests/jax_pins.py::CASES``
recomputed in one child process (``jax_in_child``, retried once on a
compiler signal) and held to the file."""

import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child

BATCHES = [
    ("pipeline", ["flood_6", "continuation_5"]),
    ("pipeline", ["matching_6"]),
    ("pipeline", ["coverage", "serial_tail", "expired"]),
]


@pytest.mark.parametrize("group,names", BATCHES, ids=["-".join(b[1]) for b in BATCHES])
def test_jax_pins_are_current(group, names):
    assert jax_in_child("tests.jax_pins", "compute", group, names) == {
        name: jax_pins.pinned(group, name) for name in names}
