"""``run_sim --profile-round`` with ``--grow``, ``--stream`` and
``--control`` (the composed rows of ROADMAP item 9f) against the JAX CLI
on the CPU: each plane validates, and the composed run prints the growth,
stream and control rows under JAX's names and in its order, its stage
table on stderr row for row. The JAX CLI's timing-free shape of the
composed run is pinned in ``tests/jax_pins.json`` (group ``profile``, case
``composed_300``; ``python -m tests.jax_pins write profile`` remakes it)."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests import jax_pins
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

PROFILE = jax_pins.PROFILE_BASE
PLANES = jax_pins.PROFILE_PLANES


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
    want = jax_pins.pinned("profile", "composed_300")
    assert tcli.main(jax_pins.PROFILE_COMPOSED + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    got = json.loads(out.out.strip().splitlines()[-1])
    assert list(got) == want["keys"] and list(got["stages_ms"]) == want["stages"]
    assert {k: got[k] for k in want["fields"]} == want["fields"]
    assert {"growth", "stream", "control"} <= set(got["stages_ms"])
    rows = [ln.split("|")[1].strip() for ln in out.err.splitlines() if ln.startswith("| ")][1:]
    assert rows == want["stages"] and out.err.count("\n| ") == want["table_rows"]

