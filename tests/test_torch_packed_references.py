"""The JAX-pinned n=20000 packed reference digests that chip_smoke.py
reproduces on the card: a packed run's summary is its unpacked twin's, and
the packed Pallas tail with SIR is what the JAX CLI prints today and what
the port's CLI prints on the CPU."""

import json

from tests.test_torch_cli import REF, _check_reference, control_pin, fault_pin, growth_pin, stream_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _flags(argv) -> frozenset:
    """The argv's ``--flag value`` groups, in any order."""
    return frozenset(" ".join(argv).split(" --"))


def _packed_refs() -> list[dict]:
    return [r for r in json.loads(REF.read_text())
            if "--packed" in r["argv"] and not fault_pin(r) and not growth_pin(r) and not stream_pin(r)
            and not control_pin(r)]


def test_packed_references_equal_their_unpacked_twins():
    refs = json.loads(REF.read_text())
    by_argv = {_flags(r["argv"]): r for r in refs}
    packed = _packed_refs()
    assert len(packed) == 5
    twins = 0
    for ref in packed:
        assert ref["source"].startswith("python -m tpu_gossip.cli.run_sim")
        twin = by_argv.get(_flags([a for a in ref["argv"] if a != "--packed"]))
        if twin is not None:
            assert twin["summary"] == ref["summary"]
            twins += 1
    assert twins == 4


def test_packed_pallas_sir_reference_digest_is_what_jax_produces(capsys):
    (ref,) = [r for r in _packed_refs() if "--sir-recover" in r["argv"]]
    assert "pallas" in ref["argv"]
    _check_reference(capsys, ref)
