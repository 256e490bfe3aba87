"""The pipelined-round pins of ``tpu_gossip_torch/reference_pins.json``
that ``chip_smoke.py`` phase 13a reproduces on the card: ``run_sim --shard
--staircase --pipeline 1`` at n = 20000, unpacked and packed, plain and
under a stream whose age-out runs inside the horizon, each made by the JAX
CLI on one device. The port's CLI prints each pin here, the JAX CLI (in a
child process) still prints it, and depth 0 prints the serial pin of
``reference_digests.json`` with ``pipeline: 0`` added."""

import json
from pathlib import Path

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import REF, _summary
from tests.test_torch_growth_cli_engines import jax_cli_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

PINS = Path(__file__).resolve().parent.parent / "tpu_gossip_torch" / "reference_pins.json"


def pins():
    return json.loads(PINS.read_text())["pipeline"]


@pytest.mark.parametrize("i", range(4))
def test_pipeline_pin_is_what_the_port_prints(capsys, one_shard, i):
    pin = pins()[i]
    got, _ = _summary(capsys, tcli.main, pin["argv"] + ["--device", "cpu"])
    for k, v in pin["summary"].items():
        assert got[k] == v, k


@pytest.mark.parametrize("i", range(4))
def test_pipeline_pin_is_what_jax_prints(i):
    pin = pins()[i]
    want, _ = jax_cli_child(pin["argv"], one_shard=True)
    for k, v in pin["summary"].items():
        assert want[k] == v, k


def test_depth0_prints_the_serial_pin(capsys, one_shard):
    argv = ["--peers", "20000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--shard",
            "--staircase", "--rounds", "20", "--digest", "--quiet"]
    serial = [r for r in json.loads(REF.read_text()) if r["argv"] == argv][0]
    got, _ = _summary(capsys, tcli.main, serial["argv"] + ["--pipeline", "0", "--device", "cpu"])
    assert got.pop("pipeline") == 0
    for k, v in serial["summary"].items():
        assert got[k] == v, k
