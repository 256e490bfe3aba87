"""The port's threefry keys and word helpers against jax.random and the
JAX package, bit for bit (inputs from numpy seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.kernels import pallas_segment as jseg
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SEEDS = [0, 7, 123456, 2**31 - 1]
KEY_SEEDS = SEEDS + [-5, 2**33 + 9]
SHAPES = [(1,), (5,), (3, 7), (80, 128), (1001,)]


def _key(seed):
    return jax.random.key(seed), prng.key(seed, "cpu")


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_key_data(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), prng.key_data(tk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform(seed, shape):
    jk, tk = _key(seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jb, prng.bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = prng.uniform(tk, shape).numpy()
    assert tu.dtype == ju.dtype == np.float32
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    jk, tk = _key(seed)
    js = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
    np.testing.assert_array_equal(js, prng.split(tk, num).numpy())


@pytest.mark.parametrize("data", [0, 1, 12345, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    jk, tk = _key(seed)
    jf = np.asarray(jax.random.key_data(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(jf, prng.fold_in(tk, data).numpy())


def test_split_chain_matches_round_key_discipline():
    """The round's 5-way split, then a child's re-split, as the engine does."""
    jk, tk = _key(3)
    jkeys = jax.random.split(jk, 5)
    tkeys = prng.split(tk, 5)
    for i in range(5):
        j2 = np.asarray(jax.random.key_data(jax.random.split(jkeys[i])))
        np.testing.assert_array_equal(j2, prng.split(tkeys[i]).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popcount_matches_lax(seed):
    x = np.random.default_rng(seed).integers(-2**31, 2**31, 4099, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    want = np.asarray(jax.lax.population_count(jnp.asarray(x)))
    got = tseg.popcount(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("m", [1, 7, 16, 32])
def test_pack_unpack_words(m):
    bm = np.random.default_rng(m).random((257, m)) < 0.5
    jw = np.asarray(jseg.pack_words(jnp.asarray(bm)))
    tw = tseg.pack_words(torch.from_numpy(bm)).numpy()
    np.testing.assert_array_equal(jw, tw)
    np.testing.assert_array_equal(
        np.asarray(jseg.unpack_words(jnp.asarray(jw), m)),
        tseg.unpack_words(torch.from_numpy(tw), m).numpy(),
    )


def test_slot_groups():
    for m in (1, 16, 32, 33, 70):
        assert tseg._slot_groups(m) == jseg._slot_groups(m)


def test_bernoulli_threshold_matches_f32_law():
    rng = np.random.default_rng(0)
    p = np.concatenate([
        rng.random(5000).astype(np.float32),
        (1.0 / np.arange(1, 3000, dtype=np.float32)),
        np.array([0.0, 1.0, 1.5, -0.5, 2.0**-32, 1 - 2.0**-24], dtype=np.float32),
    ])
    want = np.asarray(jseg.bernoulli_threshold_device(jnp.asarray(p))).astype(np.int64)
    got = tseg.bernoulli_threshold_device(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(want, got)
