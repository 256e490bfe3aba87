"""The JAX-pinned n=20000 reference digests of the CSR families that
chip_smoke.py reproduces on the card: each entry is what the JAX CLI
prints today, and what the port's CLI prints on the CPU."""

import pytest

from tests.test_torch_cli import _check_reference, _reference, _skip_without_jax_native_pa
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("i", [1, 2, 3, 4])
def test_csr_reference_digests_are_what_jax_produces(capsys, i):
    ref = _reference(i)
    assert ref["source"].startswith("python -m tpu_gossip.cli.run_sim")
    if "pa" in ref["argv"]:
        _skip_without_jax_native_pa()
    _check_reference(capsys, ref)
