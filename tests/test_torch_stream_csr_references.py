"""The streaming plane's JAX pins on the CSR graphs, printed by the port's
CLI on the CPU: Chung-Lu exactly-k with the degree law and two Bloom
planes, preferential attachment with the hotspot law, the Chung-Lu
staircase with bursts, the bucketed mesh with K6 and its packed twin, and
the staircase remat loop under churn (``test_torch_stream_references.py``
holds the rest and the order of the pins)."""

import pytest

from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream_references import check_stream_pin, matching_pins, stream_refs


def csr_pins():
    return [r for r in stream_refs() if r not in matching_pins()]


def test_csr_pins_are_six():
    assert len(csr_pins()) == 6


@pytest.mark.parametrize("i", range(6))
def test_stream_csr_reference_digests_are_what_the_port_prints(capsys, one_shard, i):
    check_stream_pin(capsys, csr_pins()[i])
