"""The JAX results ``tests/jax_pins.json`` pins for the streamed CLI runs
of ``test_torch_stream_cli.py`` and ``test_torch_stream_cli_engines.py``
(group ``stream_cli``) are what the JAX CLI prints today: a batch of them
recomputed in one child process (``jax_in_child``, retried once on a
compiler signal) and held to the file; ``python -m tests.jax_pins write
stream_cli`` recomputes every one."""

import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401  (builds the JAX package's PA library)

BATCHES = [("stream_cli", ["matching_packed", "pa_hotspot", "shard_k6"])]


@pytest.mark.parametrize("group,names", BATCHES, ids=["-".join(b[1]) for b in BATCHES])
def test_jax_pins_are_current(group, names):
    assert jax_in_child("tests.jax_pins", "compute", group, names) == {
        name: jax_pins.pinned(group, name) for name in names}
