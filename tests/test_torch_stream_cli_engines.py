"""Each engine under ``run_sim --stream`` at n=2000, the port's CLI against
the JAX CLI on the CPU: Chung-Lu exactly-k with the degree law and two
Bloom planes, preferential attachment with the hotspot law, the Chung-Lu
staircase (K5) with bursts past rate 10 (the Poisson rejection branch) and
its packed twin, the one-process bucketed mesh (K6 receive, and packed
with the scatter receive), the local staircase remat loop under churn and
silent peers; the summary (the ``stream`` block and digests) and every
per-round row equal. The scenario runs are
``test_torch_stream_cli_scenarios.py``'s."""

import pytest

from tests.jax_pins import STREAM_ENGINES_ONE_SHARD
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream_cli import check_engine

ENGINES = STREAM_ENGINES_ONE_SHARD  # (their JAX results pinned in tests/jax_pins.json, group stream_cli)


@pytest.mark.parametrize("name", list(ENGINES))
def test_streamed_engine_equals_jax_cli(capsys, one_shard, name):
    check_engine(capsys, ENGINES[name], one_shard=True)
