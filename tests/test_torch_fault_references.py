"""The JAX-pinned digests of the fault plane that chip_smoke.py reproduces
on the card: BASELINE config 2 (1000 peers, 10% silent) and the four
catalogued scenarios on the matching headline at n=20000, split-brain
packed, on the staircase and on the sharded K6 path, and rack-failure
with churn on the sharded path. Each entry names its JAX source, and the
port's CLI prints it on the CPU, the ``phases`` report included. The three
1M pins (config 2's twin on the matching headline, lossy-links and
split-brain) are reproduced by chip_smoke.py alone."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import REF, _summary, fault_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _fault_refs(scale: str):
    """The fault plane's pins (the quorum detector's, which follow them,
    are test_torch_adversary_references.py's)."""
    return [r for r in json.loads(REF.read_text())
            if fault_pin(r) and "--quorum-k" not in r["argv"] and (r["argv"][1] == "1000000") == (scale == "1M")]


def test_fault_pins_follow_the_earlier_slices_pins():
    """The nineteen pins of the earlier slices come first, in their order;
    the fault pins follow, each naming its JAX source."""
    refs = json.loads(REF.read_text())
    assert not any(fault_pin(r) for r in refs[:19]) and all(fault_pin(r) for r in refs[19:39])
    assert len(_fault_refs("small")) == 9 and len(_fault_refs("1M")) == 3
    for r in refs[19:39]:
        assert r["source"].startswith("python -m tpu_gossip.cli.run_sim " + " ".join(r["argv"]))
        assert "JAX package" in r["source"]
        if "--scenario" in r["argv"]:
            assert r["summary"]["scenario"] and r["summary"]["phases"]


@pytest.mark.parametrize("i", range(9))
def test_fault_reference_digests_are_what_the_port_prints(capsys, one_shard, i):
    ref = _fault_refs("small")[i]
    got, rows = _summary(capsys, tcli.main, [a for a in ref["argv"] if a != "--quiet"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k
    if "--silent-frac" in ref["argv"]:
        # config 2: no peer declared dead through round 7, all 100 silent peers from round 8
        dead = [json.loads(r)["n_declared_dead"] for r in rows]
        assert dead[:7] == [0] * 7 and dead[7:] == [100] * (len(dead) - 7)
