"""The JAX results ``tests/jax_pins.json`` pins for the port's
pipelined-round tests on the bucketed mesh are what the JAX package
computes today: each batch of cases of ``tests/jax_pins.py::CASES``
recomputed in one child process (``jax_in_child``, retried once on a
compiler signal) and held to the file. The local engine's cases are
``test_torch_pipeline_pins_local.py``'s."""

import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child

BATCHES = [
    ("pipeline", ["bucketed_push_1", "bucketed_push_pull_1"]),
    ("pipeline", ["bucketed_push_pull_composed_None"]),
    ("pipeline", ["bucketed_push_pull_composed_1"]),
]


@pytest.mark.parametrize("group,names", BATCHES, ids=["-".join(b[1]) for b in BATCHES])
def test_jax_pins_are_current(group, names):
    assert jax_in_child("tests.jax_pins", "compute", group, names) == {
        name: jax_pins.pinned(group, name) for name in names}
