"""``run_sim --stream`` on the port's CLI against the JAX CLI on the CPU:
every refusal of the stream flags with the JAX CLI's words, the refusals
of the slices still to come (exit 2, naming the ROADMAP item), the summary's
``stream`` block, a mid-stream checkpoint resumed across the packages, and
the matching engine's runs at n=2000 (uniform and hotspot origins, the
packed twin) and packed exactly-k on PA with the summary and every
per-round row equal. The other
engines are ``test_torch_stream_cli_engines.py``'s."""

import json

import numpy as np
import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import _skip_without_jax_native_pa, _summary
from tests.jax_pins import CASES, STREAM_ENGINES, STREAM_S, pinned
from tests.test_torch_growth_cli_engines import jax_cli_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet"]
REFUSED = [
    ["--rounds", "20", "--slot-ttl", "9"],
    ["--rounds", "20", "--stream-origins", "degree"],
    ["--rounds", "20", "--stream-hashes", "2"],
    ["--rounds", "20", "--stream-burst-every", "3"],
    ["--rounds", "20", "--stream", "-1"],
    ["--rounds", "0", "--stream", "2"],
    ["--rounds", "20", "--stream", "2", "--slot-ttl", "2"],
    ["--rounds", "20", "--stream", "2", "--stream-hashes", "5"],
    ["--rounds", "20", "--stream", "2", "--stream-burst-mult", "0"],
    ["--rounds", "20", "--stream", "2", "--stream-hot-frac", "0"],
    ["--rounds", "20", "--stream", "2", "--stream-hot-weight", "1.5"],
    ["--rounds", "20", "--stream", "2", "--shard", "--remat-every", "8", "--graph", "chung-lu"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: " ".join(a[2:]))
def test_stream_refusals_in_jax_words(capsys, argv):
    assert jcli.main(BASE + argv) == 2
    want = capsys.readouterr().err.strip().splitlines()[0]
    assert tcli.main(BASE + argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[0] == want


@pytest.mark.parametrize("argv,item", [
    (["--rounds", "20", "--shard", "--graph", "matching", "--pipeline", "1"], "11b"),
    (["--rounds", "20", "--hosts", "2"], "11c"),
    (["--rounds", "20", "--transport", "sparse"], "11b"),
    (["--rounds", "20", "--shard", "--graph", "matching"], "11b"),
])
def test_stream_with_a_later_slice_exits_2_naming_its_item(capsys, monkeypatch, argv, item):
    """The stream on the sharded matching mesh (11b, ported since) equals
    the JAX CLI's run on a 2-device mesh, pipelined or not; ``--transport``
    and ``--hosts`` (11c, ported since) without ``--shard`` exit 2 in
    JAX's words."""
    from tests.test_torch_mesh_cli import equals_jax_mesh_cli

    got = equals_jax_mesh_cli(capsys, monkeypatch, BASE + ["--stream", "2", *argv])
    assert ("stream" in got) == ("--shard" in argv)


def test_stream_summary_block_equals_jax(capsys):
    argv = BASE + ["--rounds", "40", "--stream", "2", "--slot-ttl", "12"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert {k: v for k, v in got.items() if k != "packed"} == {k: v for k, v in want.items() if k != "packed"}
    s = got["stream"]
    assert s["rate"] == 2.0 and s["slot_ttl"] == 12 and s["msgs_offered"] > 0
    for key in ("delivered_msgs_per_sec", "conflation_rate", "rounds_to_coverage", "delivery_ratio",
                "episodes_completed"):
        assert key in s, key


def test_default_ttl_is_three_feasible_horizons_as_jax(capsys):
    argv = ["--peers", "2000", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--stream", "1",
            "--rounds", "12", "--quiet"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got["stream"] == want["stream"] and got["stream"]["slot_ttl"] == 3 * 15


S, ENGINES = STREAM_S, STREAM_ENGINES
TIMING = ("wall_seconds", "peers_rounds_per_sec", "ms_per_round", "ms_per_round_amortized",
          "epoch_rebuild_seconds_total", "packed")


def check_engine(capsys, argv, one_shard=False):
    """The port's CLI prints the JAX CLI's summary and rows for ``argv``."""
    if "--graph" not in argv or argv[argv.index("--graph") + 1] == "pa":
        _skip_without_jax_native_pa()
    # the JAX half pinned in tests/jax_pins.json (group stream_cli), or in a
    # child process for an unpinned argv: its in-process compile has lost a
    # test worker to XLA's CPU compiler under the suite's load
    names = [k for k, (_, args) in CASES["stream_cli"].items() if args == [one_shard, *argv]]
    if names:
        pin = pinned("stream_cli", names[0])
        want, want_rows = pin["summary"], pin["rows"]
    else:
        want, want_rows = jax_cli_child(argv, one_shard=one_shard)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert {k: v for k, v in got.items() if k not in TIMING} == {k: v for k, v in want.items() if k not in TIMING}
    got_rows, want_rows = [json.loads(r) for r in got_rows], [json.loads(r) for r in want_rows]
    # degree_gamma, a growing run's one float reduction, is held to JAX's own
    # local/sharded tolerance; every other column is equal
    np.testing.assert_allclose([r.pop("degree_gamma") for r in got_rows], [r.pop("degree_gamma") for r in want_rows],
                               rtol=1e-5)
    assert got_rows == want_rows
    assert got["stream"]["msgs_expired"] > 0
    return got


@pytest.mark.parametrize("name", list(ENGINES))
def test_streamed_run_equals_jax_cli(capsys, name):
    check_engine(capsys, ENGINES[name])


@pytest.mark.parametrize("write_with", ["port", "jax"])
def test_mid_stream_checkpoint_resumes_across_packages(capsys, tmp_path, write_with):
    """A run checkpointed every 12 rounds by one package, its last
    checkpoint removed (the crash), resumed by the other from round 24 with
    leases live: the digests and the stream block are the uninterrupted
    run's."""
    import shutil

    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--stream", "3",
            "--slot-ttl", "16", "--rounds", "40", "--quiet", "--checkpoint-every", "12"]
    full, _ = _summary(capsys, tcli.main, argv + ["--checkpoint-dir", str(tmp_path / "full"), "--device", "cpu"])
    d = tmp_path / "run"
    writer = (lambda a: tcli.main(a + ["--device", "cpu"])) if write_with == "port" else jcli.main
    assert writer(argv + ["--checkpoint-dir", str(d)]) == 0
    capsys.readouterr()
    shutil.rmtree(d / "ckpt-00000036")
    resumer = jcli.main if write_with == "port" else (lambda a: tcli.main(a + ["--device", "cpu"]))
    got, _ = _summary(capsys, resumer, ["resume", str(d)])
    for k in ("state_digest", "stats_digest", "stream", "total_msgs"):
        assert got[k] == full[k], k
