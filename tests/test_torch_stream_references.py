"""The JAX-pinned digests of the streaming plane that chip_smoke.py
reproduces on the card (phase 11): at n=20000 (rate 2 unless named, TTL
20, 40 rounds) the matching headline and its packed twin, Chung-Lu
exactly-k with the degree law and two Bloom planes, preferential
attachment with the hotspot law, the Chung-Lu staircase with bursts (rate
4, x4 every third round: the Poisson rejection branch), the bucketed mesh
with K6 and its packed twin on a one-device JAX mesh, the staircase remat
loop under config 5's churn; ``scenarios/flash_crowd_under_fire.toml`` run
as its header gives it; and the 1M matching headline under a stream
(rate 4, bursts every 6 rounds, TTL 24, 48 rounds), which chip_smoke.py
alone reproduces. Each entry names its JAX source; the port's CLI prints
the matching pins here and the CSR ones in
``test_torch_stream_csr_references.py``."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_cli import REF, _skip_without_jax_native_pa, _summary, stream_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def stream_refs(scale: str = "small"):
    return [r for r in json.loads(REF.read_text())
            if stream_pin(r) and (r["argv"][r["argv"].index("--peers") + 1] == "1000000") == (scale == "1M")]


def test_stream_pins_follow_the_growth_pins():
    """The 48 pins of the earlier slices come first, in their order; the
    streaming plane's ten follow, each naming its JAX source, each with an
    age-out inside its horizon; the packed twins' summaries are their
    twins'."""
    refs = json.loads(REF.read_text())
    assert not any(stream_pin(r) for r in refs[:48] + refs[58:]) and all(stream_pin(r) for r in refs[48:58])
    assert len(stream_refs()) == 9 and len(stream_refs("1M")) == 1
    for r in refs[48:58]:
        assert r["source"].startswith("python -m tpu_gossip.cli.run_sim " + " ".join(r["argv"]))
        assert "JAX package" in r["source"]
        s = r["summary"]["stream"]
        assert s["msgs_expired"] > 0 and s["msgs_offered"] >= s["msgs_injected"] > 0
        assert s["slot_ttl"] == int(r["argv"][r["argv"].index("--slot-ttl") + 1])
    by_argv = {" ".join(a for a in r["argv"] if a != "--packed"): r for r in refs[48:58]}
    assert sum(by_argv[" ".join(a for a in r["argv"] if a != "--packed")]["summary"] == r["summary"]
               for r in refs[48:58] if "--packed" in r["argv"]) == 2
    (flash,) = [r for r in refs[48:58] if "--scenario" in r["argv"]]
    assert flash["summary"]["state_digest"].startswith("b4de8ed7") and flash["summary"]["state_digest"].endswith("5f50")
    (big,) = stream_refs("1M")
    assert big["summary"]["stream"]["rate"] == 4.0 and big["summary"]["stream"]["slot_ttl"] == 24


def check_stream_pin(capsys, ref):
    if "--graph" not in ref["argv"] or "pa" in ref["argv"]:
        _skip_without_jax_native_pa()
    got, _ = _summary(capsys, tcli.main, [a for a in ref["argv"] if a != "--quiet"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k


def matching_pins():
    """The matching pins and the flash crowd (the rest are
    test_torch_stream_csr_references.py's)."""
    return [r for r in stream_refs() if "matching" in r["argv"] or "--scenario" in r["argv"]]


@pytest.mark.parametrize("i", range(3))
def test_stream_reference_digests_are_what_the_port_prints(capsys, i):
    check_stream_pin(capsys, matching_pins()[i])
