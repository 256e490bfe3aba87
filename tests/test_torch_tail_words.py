"""The plain word tail (K4's plain version) against the JAX package's two
forms of ``round_tail_words``, bit for bit, over K4's grid: ragged slot
counts, forward-once, SIR, fresh rows and expired columns, and a round
past ROUND_CAP in both SIR-age modes (the XLA word chain's wide age,
``pallas=False``; the Pallas kernel's saturated age, in interpret mode)."""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core.packed import pack_bits as jpack
from tpu_gossip.kernels import round_tail as jtail
from tpu_gossip_torch.core.packed import pack_bits as tpack
from tpu_gossip_torch.core.packed import word_mask
from tpu_gossip_torch.kernels import round_tail as ttail
from tests.test_torch_packed import NAMES, cap_edge_operands
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

GRID = list(itertools.product([16, 13, 1, 17], [False, True], [0, 4]))


@functools.lru_cache(maxsize=None)
def _jax_form(m, forward_once, sir, pallas, has_fresh, has_expired):
    """One JAX form, jitted once per static configuration (the round is a
    traced operand, so both rounds share the compile)."""

    def run(*args):
        *words, fresh, rnd, expired = args
        return jtail.round_tail_words(
            *words, fresh if has_fresh else None, rnd, m=m, forward_once=forward_once,
            sir_recover_rounds=sir, expired=expired if has_expired else None, pallas=pallas,
            interpret=True if pallas else None)

    return jax.jit(run)


@pytest.mark.parametrize("m,forward_once,sir", GRID)
def test_plain_word_tail_equals_both_jax_forms(m, forward_once, sir):
    ops, fresh, expired = cap_edge_operands(300, m, m * 7 + sir + forward_once, 0)
    ir = ops["infected_round"]
    j_words = [jpack(jnp.asarray(ops[k])) if k != "infected_round" else jnp.asarray(ir) for k in NAMES]
    t_words = [tpack(torch.from_numpy(ops[k])) if k != "infected_round" else torch.from_numpy(ir) for k in NAMES]
    pad = ~word_mask(m)
    for has_fresh, has_expired, rnd, pallas in itertools.product([False, True], [False, True], [9, 32771],
                                                                 [False, True]):
        want = _jax_form(m, forward_once, sir, pallas, has_fresh, has_expired)(
            *j_words, jnp.asarray(fresh), jnp.asarray(rnd, jnp.int32), jnp.asarray(expired))
        got = ttail.round_tail_words(
            *t_words, torch.from_numpy(fresh) if has_fresh else None, torch.tensor(rnd, dtype=torch.int32),
            m=m, forward_once=forward_once, sir_recover_rounds=sir,
            expired=torch.from_numpy(expired) if has_expired else None, pallas=pallas)
        for name, a, g in zip(("seen", "forwarded", "infected_round", "recovered"), want, got):
            a = np.asarray(a)
            assert a.dtype == g.numpy().dtype, name
            np.testing.assert_array_equal(g.numpy(), a, err_msg=f"{name} fresh={has_fresh} "
                                          f"expired={has_expired} rnd={rnd} pallas={pallas}")
            if name != "infected_round":
                assert not (g & pad).any(), f"{name}: a padding bit is set"
