"""The port's CLI against the JAX CLI, and the JAX-pinned reference digests
that chip_smoke.py reproduces on the card."""

import json
from pathlib import Path

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

REF = Path(__file__).resolve().parent.parent / "tpu_gossip_torch" / "reference_digests.json"


def control_pin(ref) -> bool:
    """A pin of the adaptive controller (``--control``): the last slice's,
    after the streaming plane's."""
    return "--control" in ref["argv"]


def stream_pin(ref) -> bool:
    """A pin of the streaming plane (``--stream``, no controller), after
    the growth plane's."""
    return "--stream" in ref["argv"] and not control_pin(ref)


def growth_pin(ref) -> bool:
    """A pin of the growth plane (``--grow``, no stream, no controller),
    after the quorum detector's."""
    return "--grow" in ref["argv"] and not stream_pin(ref) and not control_pin(ref)


def fault_pin(ref) -> bool:
    """A pin of the fault plane (silent peers or a scenario, no growth, no
    stream, no controller); the pins of earlier slices are the others but
    the growth, stream and control pins."""
    return ("--scenario" in ref["argv"] or "--silent-frac" in ref["argv"]) and not growth_pin(ref) and (
        not stream_pin(ref)) and not control_pin(ref)


def _summary(capsys, main, argv):
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


@pytest.mark.parametrize("extra", [[], ["--forward-once", "--sir-recover", "3"]])
def test_cli_digest_summary_equals_jax(capsys, extra):
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching",
            "--rounds", "20", "--digest", *extra]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]


def test_cli_run_to_target_rounds_equal_jax(capsys):
    argv = ["--peers", "2000", "--mode", "push", "--fanout", "3", "--graph", "matching", "--seed", "5"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("summary", "mode", "n_peers", "rounds", "target", "coverage", "packed"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


def _reference(i):
    return json.loads(REF.read_text())[i]


def test_reference_digests_are_what_jax_produces(capsys):
    ref = _reference(0)
    assert "matching" in ref["argv"]
    _check_reference(capsys, ref)


def _skip_without_jax_native_pa():
    from tpu_gossip.native import pa_edges_native

    if pa_edges_native(10, 2) is None:
        pytest.skip("the JAX CLI's --graph pa needs libtpugossip.so (make -C tpu_gossip/native)")


def _check_reference(capsys, ref):
    want, _ = _summary(capsys, jcli.main, ref["argv"])
    for k, v in ref["summary"].items():
        assert want[k] == v, k
    got, _ = _summary(capsys, tcli.main, ref["argv"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k


CSR_RUNS = [
    ["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1"],
    ["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--staircase"],
    ["--graph", "chung-lu", "--mode", "flood"],
    ["--graph", "chung-lu", "--mode", "flood", "--staircase"],
    ["--graph", "pa", "--mode", "push", "--fanout", "3", "--m", "2"],
    ["--graph", "pa", "--mode", "push_pull", "--fanout", "1", "--staircase", "--slots", "40"],
]


@pytest.mark.parametrize("extra", CSR_RUNS, ids=lambda a: "_".join(x.strip("-") for x in a))
def test_cli_csr_families_equal_jax(capsys, extra):
    if "pa" in extra:
        _skip_without_jax_native_pa()
    argv = ["--peers", "2000", "--rounds", "20", "--digest", "--seed", "3", *extra]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]
    assert got["total_msgs"] > 0


def test_cli_staircase_run_to_target_equals_jax(capsys):
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--staircase"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("summary", "mode", "n_peers", "rounds", "target", "coverage", "packed"):
        assert got[k] == want[k], k


def test_cli_staircase_with_matching_graph_is_ignored_with_a_note(capsys):
    argv = ["--peers", "500", "--mode", "push_pull", "--fanout", "1", "--graph", "matching", "--rounds", "3",
            "--digest", "--quiet", "--device", "cpu"]
    plain, _ = _summary(capsys, tcli.main, argv)
    assert tcli.main(argv + ["--staircase"]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == plain
    assert "--staircase is ignored" in out.err


@pytest.mark.parametrize("graph", ["matching", "chung-lu"])
def test_cli_packed_digest_summary_equals_jax(capsys, graph):
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", graph, "--packed",
            "--rounds", "20", "--digest"]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want and got["packed"] is True
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]
    unpacked, _ = _summary(capsys, tcli.main, [a for a in argv if a != "--packed"] + ["--device", "cpu"])
    assert dict(unpacked, packed=True) == got


def test_cli_packed_run_to_target_equals_jax(capsys):
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--packed"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("summary", "mode", "n_peers", "rounds", "target", "coverage", "packed"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


@pytest.mark.parametrize("argv", [
    ["--graph", "chung-lu", "--control", "0.9", "--rounds", "8", "--transport", "sparse", "--device", "cpu"],
    ["--graph", "pa", "--stream", "0.5", "--rounds", "20", "--hosts", "2", "--device", "cpu"],
    ["--graph", "matching", "--shard", "--max-rounds", "40", "--device", "cpu"],
    ["--graph", "matching", "--control", "0.9", "--rounds", "8", "--shard", "--pipeline", "1", "--device", "cpu"],
])
def test_cli_flags_of_later_slices_exit_2(capsys, monkeypatch, argv):
    """The sharded matching engine and the transports (11b, ported since)
    equal the JAX CLI on a 2-device mesh; ``--transport`` without
    ``--shard`` and ``--hosts`` without it (11c, ported since) exit 2 in
    JAX's words."""
    from tests.test_torch_mesh_cli import equals_jax_mesh_cli

    got = equals_jax_mesh_cli(capsys, monkeypatch, ["--peers", "100", *argv[:-2]])
    assert ("devices" in got) == ("--shard" in argv)
