"""The bucketed mesh and the remat loops under ``--control`` on the port's
CLI against the JAX CLI on the CPU, at n=2000: the mesh on one shard with
K6 and to the target, the staircase remat loop with the refresh, the
exactly-k remat loop to the target (JAX prints no control block there)
and the sharded remat loop with the refresh; each summary, its control
blocks and every per-round row equal the JAX CLI's."""

import pytest

from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_control_cli import M, check_engine
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ENGINES = {
    "shard_staircase": M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--staircase", "--control", "0.9",
                            "--rounds", "16"],
    "shard_to_target": M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--control", "0.95"],
    "remat_staircase": M + ["--graph", "chung-lu", "--staircase", "--fanout", "2", "--churn-leave", "0.01",
                            "--churn-join", "0.05", "--rewire-slots", "4", "--remat-every", "6", "--refresh-every",
                            "2", "--control", "0.9", "--rounds", "16"],
    "remat_to_target": M + ["--graph", "chung-lu", "--fanout", "2", "--churn-join", "0.05", "--rewire-slots", "4",
                            "--remat-every", "6", "--control", "0.9"],
    "shard_remat": M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--churn-leave", "0.01", "--churn-join",
                        "0.05", "--rewire-slots", "4", "--remat-every", "6", "--refresh-every", "3", "--control",
                        "0.9", "--rounds", "16"],
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_controlled_mesh_and_remat_equal_jax_cli(capsys, one_shard, name):
    check_engine(capsys, ENGINES, name)
