"""Fleet checkpoints through ``run_sim fleet --checkpoint-every`` (one file
a lane) written by one package, cut after a mid-horizon checkpoint and
finished by the other, whole and as ``resume D --lane K --solo``, onto the
uninterrupted run's digests; the resume refusals of fleet and run
checkpoints in JAX's words. The campaign is ``test_torch_fleet_cli.py``'s;
the JAX CLI runs in a child process."""

import shutil

import pytest

from tests.test_torch_fleet_cli import campaign, port, refusal, untimed  # noqa: F401
from tests.test_torch_growth_cli_engines import jax_cli_child, jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("write_with", ["port", "jax"])
def test_fleet_checkpoint_resumes_across_packages(capsys, campaign, tmp_path, write_with):
    """One package checkpoints the campaign every 4 rounds (a file a lane),
    its ckpt-8 is removed (the crash), and the other package finishes it
    from round 4, whole and one lane alone: the digests are the
    uninterrupted run's."""
    full = port(capsys, ["fleet", campaign])
    d = tmp_path / "ckpt"
    argv = ["fleet", campaign, "--checkpoint-every", "4", "--checkpoint-dir", str(d)]
    if write_with == "port":
        written = port(capsys, argv)
    else:
        written = jax_cli_child(argv)[0]
    assert written["lane_digests"] == full["lane_digests"]
    assert sorted(p.name for p in d.iterdir() if p.name.startswith("ckpt-")) == ["ckpt-00000004", "ckpt-00000008"]
    assert len(list((d / "ckpt-00000004").glob("lane-*.npz"))) == 4
    shutil.rmtree(d / "ckpt-00000008")
    if write_with == "port":
        lane = jax_cli_child(["resume", str(d), "--lane", "3", "--solo"])[0]
        whole = jax_cli_child(["resume", str(d)])[0]
    else:
        lane = port(capsys, ["resume", str(d), "--lane", "3", "--solo"])
        whole = port(capsys, ["resume", str(d)])
    assert lane == {"summary": True, "fleet": "solo-resume", "campaign": "cli-small", "lane": 3,
                    "state_digest": full["lane_digests"]["3"]}
    assert untimed(whole) == untimed(full)


def test_resume_refusals_in_jax_words(capsys, campaign, tmp_path):
    d, r = tmp_path / "fleet", tmp_path / "run"
    assert "lane_digests" not in port(capsys, ["fleet", campaign, "--checkpoint-every", "8", "--checkpoint-dir",
                                               str(d), "--quiet"])
    port(capsys, ["--peers", "64", "--rounds", "8", "--checkpoint-every", "4", "--checkpoint-dir", str(r), "--quiet"])
    argvs = [["resume", str(d), "--lane", "1"], ["resume", str(d), "--solo"], ["resume", str(d), "--local"],
             ["resume", str(r), "--lane", "1", "--solo"], ["resume", str(d), "--lane", "7", "--solo"]]
    want = [[rc, err.strip().splitlines()[-1]] for rc, err in jax_in_child("tests.jax_pins", "cli_exits", argvs)]
    assert [refusal(argv, capsys) for argv in argvs] == want
