"""The port's round equals the JAX round in the other protocol modes of
the matching path: push with fanout 3, flood, forward-once and SIR. The
n=20000 flood's JAX half runs in a child process (``jax_in_child``),
retried once if XLA's CPU compiler kills it with a signal."""

import pytest

from tpu_gossip_torch.sim.engine import simulate as tsim
from tpu_gossip_torch.utils.digest import state_digest, stats_digest
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread, assert_same_run, build_both, build_jax, build_port  # noqa: F401

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


FOLD_SCALE = dict(mode="flood", forward_once=True, sir_recover_rounds=4)


def jax_fold_scale_run(n, rounds):
    """The JAX half of :func:`test_flood_with_sir_at_fold_scale`: the
    digests and the coverage track."""
    from tpu_gossip.fleet.engine import state_digest as j_state_digest
    from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
    from tpu_gossip.sim.engine import simulate as jsim

    jc, js, jp = build_jax(n, **FOLD_SCALE)
    jf, jst = jsim(js, jc, rounds, jp)
    return {"state_digest": j_state_digest(jf), "stats_digest": j_stats_digest(jst),
            "coverage": [float(c) for c in jst.coverage]}


def test_flood_with_sir_at_fold_scale():
    """n=20000 flood + forward-once + SIR: position-major OR fold every round."""
    tc, ts, tp = build_port(20000, **FOLD_SCALE)
    tf, tst = tsim(ts, tc, 12, tp)
    assert jax_in_child("tests.test_torch_modes", "jax_fold_scale_run", 20000, 12) == {
        "state_digest": state_digest(tf), "stats_digest": stats_digest(tst),
        "coverage": [float(c) for c in tst.coverage]}
