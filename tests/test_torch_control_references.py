"""The JAX-pinned digests of the adaptive controller that chip_smoke.py
reproduces on the card (phase 12), after the 58 of the earlier slices: at
n=20000 and 32 rounds the matching headline under ``--control 0.99`` and
its packed twin, preferential attachment with fresh edges and the
PeerSwap refresh (the exactly-k path at width ``hi``), the Chung-Lu
staircase under a late loss scenario (K5's scaled thresholds: its
``control_fanout`` visits 5 at the base fanout 3), and the bucketed mesh
with K6 and its packed twin on a one-device JAX mesh;
``scenarios/degraded_under_control.toml`` as its header runs it; and at
1M, which chip_smoke.py alone reproduces, ``bench_control``'s policy on
the local matching engine (48 rounds) and the stream headline under the
controller (48 rounds). Each entry names its JAX source; a scenario given
as text is written to a file where its argv names it."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_cli import REF, _skip_without_jax_native_pa, _summary, control_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SCENARIO_ARG = "LATE_LOSS_TOML"


def control_refs(scale: str = "small"):
    return [r for r in json.loads(REF.read_text())
            if control_pin(r) and (r["argv"][r["argv"].index("--peers") + 1] == "1000000") == (scale == "1M")]


def pin_argv(ref, tmp_path) -> list[str]:
    """The pin's argv with a scenario given as text written to a file."""
    if "scenario_text" not in ref:
        return list(ref["argv"])
    path = tmp_path / "late_loss.toml"
    path.write_text(ref["scenario_text"])
    return [str(path) if a == SCENARIO_ARG else a for a in ref["argv"]]


def test_control_pins_follow_the_stream_pins():
    """The 58 pins of the earlier slices come first, in their order; the
    controller's nine follow, each naming its JAX source; the packed twins'
    summaries are their twins'; the late-loss pin carries its scenario's
    text."""
    refs = json.loads(REF.read_text())
    assert not any(control_pin(r) for r in refs[:58]) and all(control_pin(r) for r in refs[58:])
    assert len(control_refs()) == 7 and len(control_refs("1M")) == 2
    for r in refs[58:]:
        assert r["source"].startswith("python -m tpu_gossip.cli.run_sim " + " ".join(r["argv"]))
        assert "JAX package" in r["source"]
        assert r["summary"]["control"]["target_ratio"] == float(r["argv"][r["argv"].index("--control") + 1])
        assert r["summary"]["reliability"]["messages_judged"] >= 1
    by_argv = {" ".join(a for a in r["argv"] if a != "--packed"): r for r in refs[58:]}
    assert sum(by_argv[" ".join(a for a in r["argv"] if a != "--packed")]["summary"] == r["summary"]
               for r in refs[58:] if "--packed" in r["argv"]) == 2
    (late,) = [r for r in refs[58:] if "scenario_text" in r]
    assert SCENARIO_ARG in late["argv"] and late["summary"]["scenario"] == "late-loss"
    assert late["summary"]["control"]["bounds"] == [1, 6]


@pytest.mark.parametrize("i", range(7))
def test_control_reference_digests_are_what_the_port_prints(capsys, tmp_path, i):
    ref = control_refs()[i]
    if "--graph" not in ref["argv"] or "pa" in ref["argv"]:
        _skip_without_jax_native_pa()
    argv = [a for a in pin_argv(ref, tmp_path) if a != "--quiet"]
    got, rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k
    fanouts = [json.loads(r)["control_fanout"] for r in rows]
    lo, hi = ref["summary"]["control"]["bounds"]
    assert set(fanouts) <= set(range(lo, hi + 1))
    if "scenario_text" in ref:
        # the late loss widens a shrunk controller through m_eff = 5, where
        # K5's scale rounds apart from 5/3
        assert 5 in fanouts and fanouts.index(5) > fanouts.index(1)
