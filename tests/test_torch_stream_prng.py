"""The stream's arrival count: ``prng.poisson`` and ``prng.lgamma32``
against ``jax.random.poisson`` and ``jax.lax.lgamma``, bit for bit on the
CPU.

``jax.random.poisson`` runs Knuth's product of uniforms below rate 10 and
Hormann's transformed rejection from 10 up. The rejection body reads
``lgamma(k + 1)``, which XLA decomposes into a Lanczos sum with its own
``log1p``; torch's ``lgamma`` differs from it on about half of the
integers below 2^24, so the port carries XLA's decomposition
(``lgamma32``) and the multiply-adds the compiled body fuses. Each draw
here is the scalar call the stream makes (``apply_stream`` draws one
count a round), run a key at a time through ``lax.map``; the tolerance is
none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip_torch.core import prng
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

PAIRS = 25_000  # a rate; each branch draws at four rates and a sweep: 125k pairs


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@jax.jit
def _jax_poisson(keys, lam):
    return jax.lax.map(lambda kl: jax.random.poisson(kl[0], kl[1], dtype=jnp.int32), (keys, lam))


def _keys(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _both(keys: np.ndarray, lam: np.ndarray):
    want = np.asarray(_jax_poisson(jax.random.wrap_key_data(jnp.asarray(keys)), jnp.asarray(lam)))
    got = prng.poisson(torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(lam)).numpy()
    return want, got


@pytest.mark.parametrize("branch,rates,sweep", [
    ("knuth", (0.0, 0.5, 4.0, 9.999999), (0.0, 9.999999)),
    ("rejection", (10.0, 16.0, 400.0, 1e3), (10.0, 2e3)),
])
def test_poisson_equals_jax_on_each_branch(branch, rates, sweep):
    """Four rates of the branch and a uniform sweep over its range, PAIRS
    keys each; the counts are equal and their means are the rate's."""
    for i, rate in enumerate(rates):
        lam = np.full(PAIRS, rate, dtype=np.float32)
        want, got = _both(_keys(i, PAIRS), lam)
        bad = np.flatnonzero(want != got)
        assert bad.size == 0, f"rate {rate}: {bad.size} draws differ, first key {_keys(i, PAIRS)[bad[0]]}"
        assert abs(got.mean() - rate) < 5 * np.sqrt(max(rate, 1e-3) / PAIRS) + 1e-9
    lam = np.random.default_rng(7).uniform(*sweep, size=PAIRS).astype(np.float32)
    want, got = _both(_keys(99, PAIRS), lam)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [3.0, 12.0, 0.0, 16.0])
def test_poisson_of_one_key_equals_jax(rate):
    """The stream's form: one key (2,), a Python rate, a 0-d count."""
    for seed in range(20):
        want = int(jax.random.poisson(jax.random.key(seed), jnp.float32(rate), dtype=jnp.int32))
        got = prng.poisson(prng.key(seed, "cpu"), rate)
        assert got.shape == () and got.dtype == torch.int32 and int(got) == want


def test_lgamma32_equals_lax_lgamma_on_every_integer_to_2_24():
    """Exhaustive over the integers [1, 2^24] (the rejection branch's
    ``k + 1``), in chunks; torch.lgamma is not XLA's there."""
    jl = jax.jit(jax.lax.lgamma)
    chunk = 1 << 22
    torch_differs = 0
    for lo in range(1, (1 << 24) + 1, chunk):
        x = np.arange(lo, min(lo + chunk, (1 << 24) + 1), dtype=np.float32)
        want = np.asarray(jl(x))
        got = prng.lgamma32(torch.from_numpy(x)).numpy()
        bad = np.flatnonzero(_bits(got) != _bits(want))
        assert bad.size == 0, f"{bad.size} integers differ, first {x[bad[0]]!r}"
        torch_differs += int((_bits(torch.lgamma(torch.from_numpy(x)).numpy()) != _bits(want)).sum())
    assert torch_differs > 1 << 22  # the reason lgamma32 exists
    assert _bits(prng.lgamma32(torch.tensor([1.0])).numpy())[0] == _bits(np.asarray(jl(np.float32([1.0]))))[0] != 0


@pytest.mark.parametrize("stride", [1 << 10, 12345])
def test_lgamma32_equals_lax_lgamma_above_2_24(stride):
    """A strided sample of the float32 integers from 2^24 to 2^31 (``k``
    reaches about 10^7 when the rejection's ``us`` is tiny), and a sample
    of fractional arguments at and above 0.5."""
    jl = jax.jit(jax.lax.lgamma)
    x = np.arange(1 << 24, 1 << 31, stride * 64, dtype=np.float64).astype(np.float32)
    frac = np.random.default_rng(stride).uniform(0.5, 1e6, size=1 << 18).astype(np.float32)
    for arr in (x, frac):
        want = np.asarray(jl(arr))
        got = prng.lgamma32(torch.from_numpy(arr)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_xla_log1p_equals_jnp_log1p():
    """``log1p`` on both sides of its sqrt(2) - 1 switch: the Lanczos
    ``log t`` term's argument is ``z / 7.5``, from 0 to about 10^6."""
    g = np.random.default_rng(3)
    x = np.concatenate([g.uniform(-0.4142, 0.4142, 1 << 18), g.uniform(0.4142, 2e6, 1 << 18),
                        np.arange(0, 1 << 16) / 7.5]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = prng.xla_log1p(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
