"""Streams composed with the fault plane through ``run_sim`` at n <= 2000,
the port's CLI against the JAX CLI on the CPU: the matching headline under
``scenarios/lossy_links.toml``, the siege (``scenarios/byzantine_siege.toml``)
under the quorum detector, and ``scenarios/flash_crowd_under_fire.toml``
run as its header gives it (growth, a stream, a blackout and loss); the
summary (the ``stream`` block and digests) and every per-round row equal.
Each JAX half is pinned in ``tests/jax_pins.json`` (group ``stream_cli``,
the ``scenario_*`` cases; ``tests/test_torch_stream_pins.py`` recomputes a
batch of the group in a child process)."""

import pytest

from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.jax_pins import STREAM_SCENARIOS
from tests.test_torch_stream_cli import check_engine

SCENARIOS = STREAM_SCENARIOS


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_streamed_scenario_equals_jax_cli(capsys, one_shard, name):
    got = check_engine(capsys, SCENARIOS[name], one_shard=True)
    if name == "flash_crowd_header":
        # the run the scenario file's header gives, digests as pinned
        assert got["state_digest"].startswith("b4de8ed7") and got["state_digest"].endswith("5f50")
        assert got["stats_digest"].startswith("ce521de9") and got["stats_digest"].endswith("b839")
