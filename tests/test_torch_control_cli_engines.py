"""The bucketed mesh and the remat loops under ``--control`` on the port's
CLI against the JAX CLI on the CPU, at n=2000: the mesh on one shard with
K6 and to the target, the staircase remat loop with the refresh, the
exactly-k remat loop to the target (JAX prints no control block there)
and the sharded remat loop with the refresh; each summary, its control
blocks and every per-round row equal the JAX CLI's (pinned in
``tests/jax_pins.json``, group ``control_cli``)."""

import pytest

from tests import jax_pins
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_control_cli import check_engine
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ENGINES = jax_pins.CONTROL_CLI_MESH


@pytest.mark.parametrize("name", list(ENGINES))
def test_controlled_mesh_and_remat_equal_jax_cli(capsys, one_shard, name):
    check_engine(capsys, ENGINES, name)
