"""The port's round equals the JAX round in the other protocol modes of
the matching path: push with fanout 3, flood, forward-once and SIR."""

import pytest

from tests.test_torch_slice import _one_torch_thread, assert_same_run, build_both  # noqa: F401

MODES = {
    "push_f3": dict(mode="push", fanout=3),
    "flood": dict(mode="flood"),
    "forward_once": dict(mode="push_pull", fanout=1, forward_once=True),
    "sir4": dict(mode="push_pull", fanout=1, sir_recover_rounds=4),
}


@pytest.mark.parametrize("name", list(MODES))
def test_simulate_digests_equal_jax(name):
    _, tst = assert_same_run(*build_both(2000, **MODES[name]), rounds=20)
    assert int(tst.msgs_sent.sum()) > 0


def test_flood_with_sir_at_fold_scale():
    """n=20000 flood + forward-once + SIR: position-major OR fold every round."""
    assert_same_run(*build_both(20000, mode="flood", forward_once=True, sir_recover_rounds=4), rounds=12)
