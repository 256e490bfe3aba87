"""``run_sim --profile-round`` with ``--grow``, ``--stream`` and
``--control`` (the composed rows of ROADMAP item 9f) against the JAX CLI
on the CPU: each plane validates, and the composed run prints the growth,
stream and control rows under JAX's names and in its order, its stage
table on stderr row for row. The JAX CLI runs in a child process."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_growth_cli_engines import jax_cli_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

PROFILE = ["--peers", "300", "--mode", "push_pull", "--fanout", "2", "--profile-round", "2"]
PLANES = {"grow": ["--grow", "360", "--grow-rate", "12"], "stream": ["--stream", "2", "--slot-ttl", "12"],
          "control": ["--control", "0.99"]}


@pytest.mark.parametrize("plane", list(PLANES))
def test_profile_round_takes_each_plane(plane):
    """``--profile-round`` with ``--grow``, ``--stream`` or ``--control``
    validates (the composed rows came with ROADMAP item 9f)."""
    args = tcli.build_parser().parse_args(PROFILE + PLANES[plane] + ["--device", "cpu"])
    assert tcli.validate(args) is None


def test_profile_round_composed_rows_equal_jax(capsys):
    """The growth, stream and control rows, between the key splits and
    the transport probe, in the JAX CLI's order and names; the stage table
    on stderr row for row."""
    argv = PROFILE + PLANES["grow"] + PLANES["stream"] + PLANES["control"]
    want, _ = jax_cli_child(argv)
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    got = json.loads(out.out.strip().splitlines()[-1])
    assert list(got) == list(want) and list(got["stages_ms"]) == list(want["stages_ms"])
    assert {"growth", "stream", "control"} <= set(got["stages_ms"])
    rows = [ln.split("|")[1].strip() for ln in out.err.splitlines() if ln.startswith("| ")][1:]
    assert rows == list(want["stages_ms"])
