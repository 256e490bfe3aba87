"""The packed codec, the word ops and the word tail against the JAX package,
bit for bit, at ragged slot counts; and the SIR age past ROUND_CAP, where
each port tail impl must equal its JAX namesake."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import packed as jpk
from tpu_gossip.kernels import packed_ops as jpo
from tpu_gossip.kernels import round_tail as jtail
from tpu_gossip_torch import convert
from tpu_gossip_torch.core import packed as tpk
from tpu_gossip_torch.kernels import native
from tpu_gossip_torch.kernels import packed_ops as tpo
from tpu_gossip_torch.kernels import round_tail as ttail
from tests.test_torch_slice import _one_torch_thread, build_both  # noqa: F401

MS = [1, 8, 13, 16, 17]
NAMES = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")


def _bools(shape, seed, p=0.4):
    return np.random.default_rng(seed).random(shape) < p


def _eq(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("m", MS)
def test_codec_equals_jax(m):
    x = _bools((57, m), m)
    words_j = jpk.pack_bits(jnp.asarray(x))
    words_t = tpk.pack_bits(torch.from_numpy(x))
    _eq(words_j, words_t)
    _eq(jpk.unpack_bits(words_j, m), tpk.unpack_bits(words_t, m))
    for slot in {0, m // 2, m - 1}:
        _eq(jpk.bit_column(words_j, slot), tpk.bit_column(words_t, slot))
    _eq(jpk.word_mask(m), tpk.word_mask(m))
    assert tpk.packed_width(m) == jpk.packed_width(m)
    w32_j = jpk.words8_to_words32(words_j)
    w32_t = tpk.words8_to_words32(words_t)
    _eq(w32_j, w32_t)
    _eq(jpk.words32_to_words8(w32_j, words_j.shape[-1]), tpk.words32_to_words8(w32_t, words_t.shape[-1]))
    # all-ones words reach bit 31 of the int32 transcode
    ones = np.full((3, 7), 0xFF, np.uint8)
    _eq(jpk.words8_to_words32(jnp.asarray(ones)), tpk.words8_to_words32(torch.from_numpy(ones)))
    np.testing.assert_array_equal(tpk.np_pack_bits(x), jpk.np_pack_bits(x))
    np.testing.assert_array_equal(tpk.np_unpack_bits(np.asarray(words_j), m), jpk.np_unpack_bits(np.asarray(words_j), m))


def test_flags_equal_jax():
    planes = {name: _bools((300,), i, 0.5) for i, name in enumerate(tpk.FLAG_PLANES)}
    word_j = jpk.pack_flags({k: jnp.asarray(v) for k, v in planes.items()})
    word_t = tpk.pack_flags({k: torch.from_numpy(v) for k, v in planes.items()})
    _eq(word_j, word_t)
    np.testing.assert_array_equal(tpk.np_pack_flags(planes), np.asarray(word_j))
    for name in tpk.FLAG_PLANES:
        _eq(jpk.unpack_flag(word_j, name), tpk.unpack_flag(word_t, name))
        np.testing.assert_array_equal(tpk.np_unpack_flag(np.asarray(word_j), name), planes[name])
    assert tpk.FLAG_BITS == jpk.FLAG_BITS and tpk.BIT_PLANES == jpk.BIT_PLANES


def test_host_planes_equal_jax():
    m = 13
    host = {p: _bools((40, m), i) for i, p in enumerate(tpk.BIT_PLANES)}
    host.update({n: _bools((40,), 10 + i) for i, n in enumerate(tpk.FLAG_PLANES)})
    host["last_hb"] = np.arange(40, dtype=np.int16)
    want, got = jpk.pack_host_planes(host), tpk.pack_host_planes(host)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    arrays = {f"field_{k}": v for k, v in got.items()}
    back_j, back_t = jpk.decode_host_planes(arrays, m), tpk.decode_host_planes(arrays, m)
    assert set(back_j) == set(back_t)
    for k in back_j:
        np.testing.assert_array_equal(back_t[k], back_j[k])


def _jax_leaves(state) -> dict:
    return {f.name: np.asarray(jax.random.key_data(state.rng) if f.name == "rng" else getattr(state, f.name))
            for f in dataclasses.fields(state) if not f.metadata.get("static")}


def test_pack_state_leaves_equal_jax_and_round_trip():
    from tpu_gossip.fleet.engine import state_digest as j_state_digest
    from tpu_gossip_torch.utils.digest import state_digest as t_state_digest

    (_, js, _), (_, ts, _) = build_both(2000, seed=1, mode="push_pull", fanout=1)
    jp, tp = jpk.pack_state(js), tpk.pack_state(ts)
    assert tp.msg_slots == jp.msg_slots == 16 and tpk.is_packed(tp) and not tpk.is_packed(ts)
    want, got = _jax_leaves(jp), convert.to_numpy(tp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert t_state_digest(tp) == j_state_digest(jp)
    assert t_state_digest(tpk.unpack_state(tp)) == t_state_digest(ts) == j_state_digest(js)
    np.testing.assert_array_equal(tp.coverage(0).numpy(), np.asarray(jp.coverage(0)))
    carried = convert.packed_state_from_jax(want, jp.msg_slots, device="cpu")
    assert t_state_digest(carried) == j_state_digest(jp)


@pytest.mark.parametrize("m", MS)
def test_packed_ops_equal_jax(m):
    n = 61
    a, b = _bools((n, m), m), _bools((n, m), m + 1, 0.6)
    wa_j, wb_j = jpk.pack_bits(jnp.asarray(a)), jpk.pack_bits(jnp.asarray(b))
    wa_t, wb_t = tpk.pack_bits(torch.from_numpy(a)), tpk.pack_bits(torch.from_numpy(b))
    rows = _bools((n,), 3, 0.7)
    rows[:5] = False  # some empty rows for rows_any
    wa_j = jpo.mask_rows(wa_j, jnp.asarray(rows))
    wa_t = tpo.mask_rows(wa_t, torch.from_numpy(rows))
    _eq(wa_j, wa_t)
    for fn in ("or_words", "and_words", "andnot_words"):
        _eq(getattr(jpo, fn)(wa_j, wb_j), getattr(tpo, fn)(wa_t, wb_t))
    _eq(jpo.not_words(wa_j, m), tpo.not_words(wa_t, m))
    col = tpk.pack_bits(torch.from_numpy(~_bools((m,), 5)))
    _eq(jpo.mask_cols(wa_j, jnp.asarray(col.numpy())), tpo.mask_cols(wa_t, col))
    for fn in ("rows_any", "popcount_rows", "popcount_cols", "count_bits"):
        _eq(getattr(jpo, fn)(wb_j), getattr(tpo, fn)(wb_t))
    _eq(jpo.role_words(wb_j, jnp.asarray(rows), m), tpo.role_words(wb_t, torch.from_numpy(rows), m))
    # padding stays zero through the NOT
    assert not (tpo.not_words(wa_t, m) & ~tpk.word_mask(m)).any()
    rng = np.random.default_rng(m)
    tgt = rng.integers(0, n, (n, 3)).astype(np.int32)
    valid = rng.random((n, 3)) < 0.7
    _eq(jpo.pull_words(wb_j, jnp.asarray(tgt), jnp.asarray(valid)),
        tpo.pull_words(wb_t, torch.from_numpy(tgt), torch.from_numpy(valid)))
    _eq(jpo.gather_or_words(wb_j, jnp.asarray(tgt), jnp.asarray(valid)),
        tpo.gather_or_words(wb_t, torch.from_numpy(tgt), torch.from_numpy(valid)))


def cap_edge_operands(n, m, seed, rnd):
    """Tail operands whose ``infected_round`` holds ROUND_CAP, -1 and small
    values, and mostly receptive incoming deliveries."""
    rng = np.random.default_rng(seed)
    b = lambda p: rng.random((n, m)) < p  # noqa: E731
    ir = rng.choice(np.array([32767, 32766, -1, 0, 1, 5, 8], np.int16), (n, m))
    ops = dict(seen=b(0.5), forwarded=b(0.3), infected_round=ir, recovered=b(0.2),
               incoming=b(0.5), receptive=b(0.9), transmit=b(0.5))
    return ops, rng.random(n) < 0.1, rng.random(m) < 0.3


# each port impl against its JAX namesake: the XLA forms take the SIR age
# from the wide round, the Pallas forms from the saturated one
NAMESAKES = {
    "fused": lambda *a, **k: jtail.tail_fused(*a, **k),
    "pallas": lambda *a, **k: jtail.tail_pallas(*a, interpret=True, **k),
    "packed": lambda *a, **k: jtail.tail_packed(*a, **k),
    "packed_pallas": lambda *a, **k: jtail.tail_packed(*a, pallas=True, interpret=True, **k),
}


@pytest.mark.parametrize("rnd", [9, 32771])
@pytest.mark.parametrize("impl", list(NAMESAKES))
def test_sir_age_past_round_cap_equals_jax_namesake(impl, rnd):
    ops, fresh, expired = cap_edge_operands(64, 13, 5, rnd)
    kw = dict(forward_once=True, sir_recover_rounds=4)
    j_args = [jnp.asarray(ops[k]) for k in NAMES] + [jnp.asarray(fresh), jnp.asarray(rnd, jnp.int32)]
    t_args = [torch.from_numpy(ops[k]) for k in NAMES] + [torch.from_numpy(fresh), torch.tensor(rnd, dtype=torch.int32)]
    for j_exp, t_exp in ((None, None), (jnp.asarray(expired), torch.from_numpy(expired))):
        want = NAMESAKES[impl](*j_args, expired=j_exp, **kw)
        got = ttail.round_tail(*t_args, expired=t_exp, impl=impl, **kw)
        for a, g in zip(want, got):
            _eq(a, g)
    if rnd > 2**15:
        # the edge the two ages disagree on: a latch at the cap recovers
        # under the wide age and not under the saturated one
        rec = got[3].numpy()
        at_cap = (ops["infected_round"] == 32767) & ~fresh[:, None] & ~expired[None, :]
        if impl in ("fused", "packed"):
            assert rec[at_cap].all()
        else:
            assert not (rec & ~ops["recovered"])[at_cap].any()


def test_tail_packed_equals_jax():
    from tests.test_torch_kernels import _tail_inputs

    ops = _tail_inputs(200, 13, 7, 9)
    kw = dict(forward_once=True, sir_recover_rounds=4)
    j_args = [jnp.asarray(ops[k]) for k in NAMES] + [jnp.asarray(ops["fresh"]), jnp.asarray(9, jnp.int32)]
    t_args = [torch.from_numpy(ops[k]) for k in NAMES] + [torch.from_numpy(ops["fresh"]),
                                                          torch.tensor(9, dtype=torch.int32)]
    want = jtail.tail_packed(*j_args, expired=jnp.asarray(ops["expired"]), **kw)
    got = ttail.tail_packed(*t_args, expired=torch.from_numpy(ops["expired"]), **kw)
    for a, g in zip(want, got):
        _eq(a, g)
    fused = ttail.tail_fused(*t_args, expired=torch.from_numpy(ops["expired"]), **kw)
    for a, g in zip(fused, got):
        assert torch.equal(a, g)


def test_round_tail_words_takes_plain_on_cpu_and_refuses_other_devices():
    m, n = 13, 8
    w = torch.zeros((n, 2), dtype=torch.uint8)
    ir = torch.full((n, m), -1, dtype=torch.int16)
    before = dict(native.LAUNCHES)
    out = ttail.round_tail_words(w, w, ir, w, w, w, w, None, torch.tensor(1, dtype=torch.int32), m=m,
                                 forward_once=False, sir_recover_rounds=0)
    assert native.LAUNCHES == before
    assert out[1] is w  # forwarded passes through when nothing touches it
    meta_w, meta_ir = w.to("meta"), ir.to("meta")
    with pytest.raises(ValueError):
        ttail.round_tail_words(meta_w, meta_w, meta_ir, meta_w, meta_w, meta_w, meta_w, None,
                               torch.tensor(1, device="meta"), m=m, forward_once=False, sir_recover_rounds=0)
    with pytest.raises(ValueError):
        ttail.round_tail_words(w[:, :1], w, ir, w, w, w, w, None, torch.tensor(1), m=m,
                               forward_once=False, sir_recover_rounds=0)
