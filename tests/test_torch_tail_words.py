"""The plain word tail (K4's plain version) against the JAX package's two
forms of ``round_tail_words``, bit for bit, over K4's grid: ragged slot
counts, forward-once, SIR, fresh rows and expired columns, and a round
past ROUND_CAP in both SIR-age modes (the XLA word chain's wide age,
``pallas=False``; the Pallas kernel's saturated age, in interpret mode).
The JAX forms' outputs are pinned in ``tests/jax_pins.json`` (group
``tail_words``, a sha256 of each output's dtype and bytes); two grid
points are recomputed in a child process (``jax_in_child``, retried once
if XLA's CPU compiler kills it with a signal) and held to the pins."""

import itertools

import pytest
import torch

from tpu_gossip_torch.core.packed import pack_bits as tpack
from tpu_gossip_torch.core.packed import word_mask
from tpu_gossip_torch.kernels import round_tail as ttail
from tests.jax_pins import NAMES, TAIL_COMBOS, cap_edge_operands, leaf_digest, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

GRID = list(itertools.product([16, 13, 1, 17], [False, True], [0, 4]))


@pytest.mark.parametrize("m,forward_once,sir", GRID)
def test_plain_word_tail_equals_both_jax_forms(m, forward_once, sir):
    ops, fresh, expired = cap_edge_operands(300, m, m * 7 + sir + forward_once, 0)
    ir = ops["infected_round"]
    t_words = [tpack(torch.from_numpy(ops[k])) if k != "infected_round" else torch.from_numpy(ir) for k in NAMES]
    pad = ~word_mask(m)
    forms = pinned("tail_words", f"m{m}_fo{int(forward_once)}_sir{sir}")
    for (has_fresh, has_expired, rnd, pallas), want in zip(TAIL_COMBOS, forms, strict=True):
        got = ttail.round_tail_words(
            *t_words, torch.from_numpy(fresh) if has_fresh else None, torch.tensor(rnd, dtype=torch.int32),
            m=m, forward_once=forward_once, sir_recover_rounds=sir,
            expired=torch.from_numpy(expired) if has_expired else None, pallas=pallas)
        for name, digest, g in zip(("seen", "forwarded", "infected_round", "recovered"), want, got, strict=True):
            assert leaf_digest(g.numpy()) == digest, (f"{name} fresh={has_fresh} expired={has_expired} rnd={rnd} "
                                                      f"pallas={pallas}")
            if name != "infected_round":
                assert not (g & pad).any(), f"{name}: a padding bit is set"


def test_jax_pins_are_current():
    """Two grid points' pins are what the JAX package computes today
    (``python -m tests.jax_pins write tail_words`` recomputes all 16)."""
    names = ["m17_fo1_sir4", "m1_fo0_sir0"]
    assert jax_in_child("tests.jax_pins", "compute", "tail_words", names) == {
        name: pinned("tail_words", name) for name in names}
