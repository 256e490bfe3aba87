"""``--control``, ``--control-bounds`` and ``--refresh-every`` on the port's
CLI against the JAX CLI on the CPU: every refusal exits 2 with the JAX
CLI's first stderr line; the summary (its ``control`` and ``reliability``
blocks, the digests) and every per-round row equal the JAX CLI's on the
local engines at n=2000 (the exactly-k path with the refresh, the
staircase, the matching graph packed and to the target, a stream under a
scenario; the JAX CLI's summaries and rows pinned in
``tests/jax_pins.json``, group ``control_cli``, one rechecked in a child
process; the bucketed mesh and the remat loops are
``test_torch_control_cli_engines.py``'s); the items
still to come exit 2 naming them; and a controlled checkpoint written by
either package resumes in the other onto the uninterrupted run's
digests."""

import json
import shutil

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests import jax_pins
from tests.test_torch_growth_cli_engines import TIMING, jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet"]

REFUSED = [
    ["--rounds", "20", "--control-bounds", "1,4"],
    ["--rounds", "20", "--refresh-every", "3"],
    ["--rounds", "20", "--control", "1.5"],
    ["--rounds", "20", "--control", "-0.2"],
    ["--rounds", "20", "--control", "0.9", "--control-bounds", "0,4"],
    ["--rounds", "20", "--control", "0.9", "--control-bounds", "4,2"],
    ["--rounds", "20", "--control", "0.9", "--control-bounds", "3,5"],
    ["--rounds", "20", "--control", "0.9", "--control-bounds", "x"],
    ["--rounds", "20", "--control", "0.9", "--churn-join", "0.1", "--rewire-slots", "2", "--control-bounds", "1,5"],
    ["--rounds", "20", "--control", "0.9", "--fanout", "3", "--churn-join", "0.1", "--rewire-slots", "2"],
    ["--rounds", "20", "--control", "0.9", "--mode", "flood"],
    ["--rounds", "20", "--control", "0.9", "--refresh-every", "3"],
    ["--rounds", "20", "--control", "0.9", "--churn-join", "0.1", "--rewire-slots", "4", "--refresh-every", "-1"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: " ".join(a[2:]))
def test_control_refusals_in_jax_words(capsys, argv):
    assert jcli.main(BASE + argv) == 2
    want = capsys.readouterr().err.strip().splitlines()[0]
    assert tcli.main(BASE + argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[0] == want


@pytest.mark.parametrize("argv,item", [
    (["--rounds", "20", "--shard", "--graph", "matching", "--pipeline", "1"], "11b"),
    (["--rounds", "20", "--transport", "sparse"], "11b"),
    (["--rounds", "20", "--shard", "--graph", "matching"], "11b"),
])
def test_control_with_a_later_slice_exits_2_naming_its_item(capsys, monkeypatch, argv, item):
    """The controller on the sharded matching mesh (ROADMAP item 11b, ported
    since) equals the JAX CLI's run on a 2-device mesh, pipelined or not;
    ``--transport`` without ``--shard`` exits 2 in JAX's words."""
    from tests.test_torch_mesh_cli import equals_jax_mesh_cli

    got = equals_jax_mesh_cli(capsys, monkeypatch, BASE + ["--control", "0.9", *argv])
    assert ("control" in got) == ("--shard" in argv) and item == "11b"


M = jax_pins.CONTROL_M
ENGINES = jax_pins.CONTROL_CLI_LOCAL


@pytest.mark.parametrize("name", list(ENGINES))
def test_controlled_run_equals_jax_cli(capsys, one_shard, name):
    check_engine(capsys, ENGINES, name)


def check_engine(capsys, engines, name):
    """One controlled CLI run against the JAX CLI's, pinned in
    ``tests/jax_pins.json`` (group ``control_cli``, the JAX mesh on one
    device): the summary, every row and the control blocks."""
    argv = jax_pins.digest_argv(engines[name])
    pin = jax_pins.pinned("control_cli", name)
    want, want_rows = pin["summary"], pin["rows"]
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert {k: v for k, v in got.items() if k not in TIMING} == {k: v for k, v in want.items() if k not in TIMING}
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]
    if name == "remat_to_target":
        # JAX's quirk, kept: the local remat loop's run to the target prints
        # no control block
        assert "control" not in got
        return
    c = got["control"]
    assert c["target_ratio"] == float(argv[argv.index("--control") + 1]) and c["bounds"][0] >= 1
    if "--rounds" in argv:
        rel = got["reliability"]
        assert rel["messages_judged"] >= 1 and rel["msgs_per_delivered_infection"] > 0
        rows = [json.loads(r) for r in got_rows]
        assert {r["control_fanout"] for r in rows} <= set(range(c["bounds"][0], c["bounds"][1] + 1))
    if "--refresh-every" in argv and "--rounds" in argv:
        assert sum(json.loads(r)["control_refreshed"] for r in got_rows) > 0


def test_jax_pins_are_current():
    """One case of the ``control_cli`` group recomputed by the JAX CLI in a
    child process."""
    name = "staircase_bounds"
    assert jax_in_child("tests.jax_pins", "compute", "control_cli", [name]) == {
        name: jax_pins.pinned("control_cli", name)}


@pytest.mark.parametrize("write_with", ["port", "jax"])
def test_controlled_checkpoint_resumes_across_packages(capsys, tmp_path, write_with):
    """A controlled run with the refresh checkpointed every 6 rounds by one
    package, its last checkpoint removed (the crash), resumed by the other
    from round 12 (the cursor mid-trajectory, a refresh round behind it):
    the digests and both control blocks are the uninterrupted run's."""
    argv = ENGINES["exactly_k_refresh"] + ["--quiet", "--checkpoint-every", "6"]
    full, _ = _summary(capsys, tcli.main, argv + ["--checkpoint-dir", str(tmp_path / "full"), "--device", "cpu"])
    d = tmp_path / "run"
    writer = (lambda a: tcli.main(a + ["--device", "cpu"])) if write_with == "port" else jcli.main
    assert writer(argv + ["--checkpoint-dir", str(d)]) == 0
    capsys.readouterr()
    shutil.rmtree(d / "ckpt-00000018")
    resumer = jcli.main if write_with == "port" else (lambda a: tcli.main(a + ["--device", "cpu"]))
    got, _ = _summary(capsys, resumer, ["resume", str(d)])
    for k in ("state_digest", "stats_digest", "control", "reliability", "total_msgs"):
        assert got[k] == full[k], k
