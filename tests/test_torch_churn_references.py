"""The JAX-pinned n=20000 churn digests that chip_smoke.py reproduces on
the card (matching with a compact side-path table and its packed twin,
Chung-Lu staircase and exactly-k, the staircase remat loop, the sharded
K6 path and the sharded remat loop on a one-device JAX mesh): each entry
names its JAX source and the port's CLI prints it on the CPU. The 1M
churn pin is reproduced by chip_smoke.py alone."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import REF, _summary, control_pin, fault_pin, growth_pin, stream_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _churn_refs():
    return [r for r in json.loads(REF.read_text())
            if "--churn-join" in r["argv"] and "20000" in r["argv"] and not fault_pin(r) and not growth_pin(r)
            and not stream_pin(r) and not control_pin(r)]


@pytest.mark.parametrize("i", range(7))
def test_churn_reference_digests_are_what_the_port_prints(capsys, one_shard, i):
    """The n=20000 churn pins (the JAX CLI's, its source named) on the
    port's CLI; the 1M pin is reproduced by chip_smoke.py."""
    refs = _churn_refs()
    assert len(refs) == 7
    ref = refs[i]
    assert ref["source"].startswith("python -m tpu_gossip.cli.run_sim") and "JAX package" in ref["source"]
    got, _ = _summary(capsys, tcli.main, ref["argv"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k
