"""The growth plane's JAX pins on the CSR graphs (phase 10a of
chip_smoke.py): PA push fanout 3 under config 5's churn, the Chung-Lu
staircase remat loop, the bucketed mesh and its packed twin (a
one-device JAX mesh), and Chung-Lu exactly-k with silent peers; the
port's CLI prints each on the CPU."""

import pytest

from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_growth_references import _growth_refs, check_growth_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def csr_pins():
    return [r for r in _growth_refs("small") if "matching" not in r["argv"]]


def test_csr_growth_pins_cover_every_csr_engine():
    flags = [set(r["argv"]) for r in csr_pins()]
    assert len(flags) == 5
    assert any("--remat-every" in f and "--staircase" in f for f in flags)
    assert sum("--shard" in f for f in flags) == 2 and any("--churn-join" in f for f in flags)


@pytest.mark.parametrize("i", range(5))
def test_csr_growth_reference_digests_are_what_the_port_prints(capsys, one_shard, i):
    check_growth_pin(capsys, csr_pins()[i])
