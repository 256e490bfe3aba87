"""The JAX-pinned digests of the quorum detector that chip_smoke.py
reproduces on the card (phase 9a): BASELINE config 2 hardened at quorum 3
(the unhardened run's state, every silent peer declared at round 8), and
``scenarios/byzantine_siege.toml`` at n=20000 on the matching headline at
quorum 3 and 1 (the reference's single-report purge), packed, on the
staircase, on the sharded K6 path, and on preferential attachment with
config 5's churn. Each entry names its JAX source, and the port's CLI
prints it on the CPU, the ``liveness`` and ``phases`` blocks included. The
1M siege pin is reproduced by chip_smoke.py alone."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import REF, _summary, fault_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

CONFIG2_STATE = "0160383a3f26512bb086cd42c8c8931d60a0b84887de475e9ec97b0ab656aea2"


def _quorum_refs(scale: str):
    return [r for r in json.loads(REF.read_text())
            if "--quorum-k" in r["argv"] and (r["argv"][1] == "1000000") == (scale == "1M")]


def test_quorum_pins_follow_the_fault_pins():
    """The 31 pins of the earlier slices come first, in their order; the
    quorum detector's eight follow, each naming its JAX source, with its
    ``liveness`` block."""
    refs = json.loads(REF.read_text())
    assert not any("--quorum-k" in r["argv"] for r in refs[:31] + refs[39:])
    assert all("--quorum-k" in r["argv"] and fault_pin(r) for r in refs[31:39])
    assert len(_quorum_refs("small")) == 7 and len(_quorum_refs("1M")) == 1
    for r in refs[31:39]:
        assert r["source"].startswith("python -m tpu_gossip.cli.run_sim " + " ".join(r["argv"]))
        assert "JAX package" in r["source"] and r["summary"]["liveness"]["quorum_k"] in (1, 3)
        if "--scenario" in r["argv"]:
            assert r["summary"]["scenario"] == "byzantine-siege" and r["summary"]["phases"]
    by_k = {r["summary"]["liveness"]["quorum_k"]: r for r in refs[31:39] if "matching" in r["argv"]
            and "--packed" not in r["argv"] and r["argv"][1] == "20000"}
    assert by_k[3]["summary"]["liveness"]["false_evictions"] == 0
    assert by_k[1]["summary"]["liveness"]["eviction_precision"] < 0.5  # the single-report purge
    assert refs[31]["summary"]["state_digest"] == CONFIG2_STATE  # quorum costs config 2 nothing


@pytest.mark.parametrize("i", range(7))
def test_quorum_reference_digests_are_what_the_port_prints(capsys, one_shard, i):
    ref = _quorum_refs("small")[i]
    got, rows = _summary(capsys, tcli.main, [a for a in ref["argv"] if a != "--quiet"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k
    if "--silent-frac" in ref["argv"]:
        # config 2 hardened: no peer declared dead through round 7, all 100 silent peers from round 8
        dead = [json.loads(r)["n_declared_dead"] for r in rows]
        assert dead[:7] == [0] * 7 and dead[7:] == [100] * (len(dead) - 7)
