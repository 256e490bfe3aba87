"""The JAX-pinned digests of the growth plane that chip_smoke.py reproduces
on the card (phase 10a): at n=20000 growing to 22000 (24000 for
preferential attachment under config 5's churn), the matching headline
and its packed twin, PA push fanout 3 under churn, the Chung-Lu staircase
remat loop, the bucketed mesh and its packed twin on a one-device JAX
mesh, Chung-Lu exactly-k with silent peers, and the matching headline
under ``scenarios/flash_crowd_under_fire.toml`` (its join_burst waves,
blackout and loss). Each entry names its JAX source, and the port's CLI
prints it on the CPU (the matching pins here, the CSR ones in
``test_torch_growth_csr_references.py``). The 1M growing headline pin
(10b) is reproduced by chip_smoke.py alone."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_cli import REF, _skip_without_jax_native_pa, _summary, growth_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _growth_refs(scale: str):
    return [r for r in json.loads(REF.read_text()) if growth_pin(r) and (r["argv"][3] == "950000") == (scale == "1M")]


def test_growth_pins_follow_the_quorum_pins():
    """The 39 pins of the earlier slices come first, in their order; the
    growth plane's nine follow, each naming its JAX source (the streaming
    plane's come after them)."""
    refs = json.loads(REF.read_text())
    assert not any(growth_pin(r) for r in refs[:39] + refs[48:]) and all(growth_pin(r) for r in refs[39:48])
    assert len(_growth_refs("small")) == 8 and len(_growth_refs("1M")) == 1
    for r in refs[39:48]:
        assert r["source"].startswith("python -m tpu_gossip.cli.run_sim " + " ".join(r["argv"]))
        assert "JAX package" in r["source"]
        grown = r["summary"]
        assert grown["grow_target"] == int(r["argv"][r["argv"].index("--grow") + 1]) and grown["n_members"] > 20000
    (big,) = _growth_refs("1M")
    assert big["summary"]["grow_rate"] == 256 and big["summary"]["n_members"] == 950_000 + 32 * 256
    by_argv = {" ".join(a for a in r["argv"] if a != "--packed"): r for r in refs[39:48]}
    assert sum(by_argv[" ".join(a for a in r["argv"] if a != "--packed")]["summary"] == r["summary"]
               for r in refs[39:48] if "--packed" in r["argv"]) == 2  # each packed twin's summary is its twin's


def check_growth_pin(capsys, ref):
    if "pa" in ref["argv"]:
        _skip_without_jax_native_pa()
    got, _ = _summary(capsys, tcli.main, [a for a in ref["argv"] if a != "--quiet"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k


def matching_pins():
    """The pins on the matching graph (the rest are
    test_torch_growth_csr_references.py's)."""
    return [r for r in _growth_refs("small") if "matching" in r["argv"]]


@pytest.mark.parametrize("i", range(3))
def test_growth_reference_digests_are_what_the_port_prints(capsys, i):
    check_growth_pin(capsys, matching_pins()[i])
