"""Counter-based threefry2x32 keys: the port's stand-in for ``jax.random``.

Ports the parts of ``jax.random`` the main path draws from (JAX's
``jax/_src/prng.py`` threefry implementation under the default
``jax_threefry_partitionable=True`` layout), so every draw of the port
equals the JAX package's draw bit for bit:

- ``key(seed)`` holds key data ``[0, seed mod 2^32]``;
- ``bits(k, shape)[i] = x0 ^ x1`` of ``threefry2x32(k, (hi32(i), lo32(i)))``
  over the row-major flat index ``i``;
- ``split(k, n)[i] = (x0, x1)`` of the same hash at counter ``i``;
- ``fold_in(k, d) = threefry2x32(k, (0, d))``;
- ``uniform`` = ``bitcast((bits >> 9) | 0x3F800000) - 1.0`` in float32,
  then ``max(minval, floats * (maxval - minval) + minval)`` with the
  multiply-add fused, as XLA's CPU backend fuses it;
- ``gumbel(k, shape)`` = ``-log(-log(uniform(k, shape, tiny, 1)))`` (JAX's
  "low" mode), with :func:`xla_log`, the float32 ``log`` XLA's CPU backend
  emits (not ``torch.log``: the two differ by one ULP on about 14% of the
  draw's inputs). The uniform depends on ``bits >> 9`` alone, so the
  2^23 possible Gumbel values are tabulated once a device
  (:func:`gumbel_table`) and a draw is one gather;
- ``bits``, ``uniform``, ``gumbel`` and ``randint`` take a counter
  ``offset``: element ``i`` of the draw uses counter ``offset + i``, so a
  draw cut into row chunks equals the whole draw chunk by chunk; with a
  ``row_stride`` too, element ``(r, j)`` of a 2-D draw uses counter
  ``offset + r * row_stride + j``, so columns ``[c0, c0 + w)`` of a global
  ``(R, C)`` draw are ``offset = c0, row_stride = C`` (a column block);
- ``poisson(k, lam)``: ``jax.random.poisson``'s two branches, Knuth's
  product of uniforms below 10 and Hormann's transformed rejection at 10
  and above, with the float32 ``log``, ``log1p`` and ``lgamma``
  (:func:`lgamma32`, the Lanczos decomposition XLA compiles) and every
  multiply-add the compiled rejection body fuses;
- ``randint(k, shape, lo, hi)``: ``hi, lo = bits`` of ``split(k)``'s two
  children, ``span = uint32(hi - lo)`` (1 where ``hi <= lo``),
  ``mult = (2^16 % span)^2 % span`` and ``off = ((hi_bits % span) * mult +
  lo_bits % span) % span``, every product and sum wrapped to 32 bits as
  the uint32 arithmetic of ``jax.random.randint`` wraps it (so ``mult`` is
  0 for any span of 2^16 or more).

A key is an int64 tensor of shape (2,) holding two uint32 words. All word
arithmetic runs in int64 masked to 32 bits: ``>>`` on ``torch.uint32`` is
not implemented on the CPU. The port never touches the global torch RNG.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.device import resolve_device

__all__ = ["key", "split", "fold_in", "bits", "uniform", "gumbel", "gumbel_table", "randint", "key_data",
           "threefry2x32", "xla_log", "xla_log1p", "lgamma32", "poisson"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """The key ``jax.random.key(seed)`` makes: data ``[0, seed mod 2^32]``."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=dev)


def key_data(k: torch.Tensor):
    """The key's two words as a numpy uint32 (2,) array (digest leaf)."""
    return k.detach().cpu().numpy().astype("uint32")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(
    k: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds over counter words ``(x0, x1)``
    (int64 tensors of uint32 values, broadcast together)."""
    k0, k1 = k[0], k[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counters(k: torch.Tensor, n: int, offset: int = 0, shape=None,
              row_stride: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The counter words of ``n`` elements from ``offset`` on; with
    ``row_stride``, of the 2-D ``shape`` whose row ``r`` starts at counter
    ``offset + r * row_stride``."""
    if row_stride is None or len(shape) == 2 and row_stride == shape[1]:
        idx = torch.arange(offset, offset + n, dtype=torch.int64, device=k.device)
    elif len(shape) != 2:
        raise ValueError(f"row_stride takes a 2-D shape, got {tuple(shape)}")
    else:
        starts = offset + torch.arange(shape[0], dtype=torch.int64, device=k.device) * int(row_stride)
        idx = (starts[:, None] + torch.arange(shape[1], dtype=torch.int64, device=k.device)).reshape(-1)
    return (idx >> 32) & _M32, idx & _M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) child keys; row ``i`` is child ``i`` (``jax.random.split``)."""
    y0, y1 = threefry2x32(k, *_counters(k, num))
    return torch.stack([y0, y1], dim=1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for a 32-bit ``data``."""
    zero = torch.zeros((1,), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k, zero, zero + (int(data) & _M32))
    return torch.cat([y0, y1])


def bits(k: torch.Tensor, shape: tuple[int, ...], offset: int = 0, row_stride: int | None = None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2^32);
    with ``offset``, the elements at flat positions ``offset + i`` of a
    larger draw; with ``row_stride`` too, the 2-D block whose row ``r``
    starts at ``offset + r * row_stride`` (a column block)."""
    n = 1
    for d in shape:
        n *= int(d)
    y0, y1 = threefry2x32(k, *_counters(k, n, offset, shape, row_stride))
    return (y0 ^ y1).reshape(shape)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it: the float64 product of two float32 values is exact, so only the
    sum rounds before the final rounding to float32. Plain float64
    arithmetic, so the CPU and the card round it alike."""
    f64 = torch.float64
    a, b, c = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c))
    # graftlint: disable=mem-widening-cast -- float32 FMA emulated in float64, bit-exact with XLA's fused multiply-add
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def uniform(k: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: on
    [0, 1) by default; else ``max(minval, floats * (maxval - minval) +
    minval)`` in float32, the multiply-add fused as XLA fuses it."""
    b = (bits(k, shape, offset) >> 9) | 0x3F800000
    return _bounded(b.to(torch.int32).view(torch.float32) - 1.0, minval, maxval)


def _bounded(floats: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """JAX's map of [0, 1) floats onto [minval, maxval)."""
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    # graftlint: disable=round-host-sync -- lo is a host tensor made from the Python float minval: no device read
    return torch.clamp(_fma32(floats, span.to(floats.device), lo.to(floats.device)), min=float(lo))


# XLA's CPU float32 log (the Cephes polynomial of its vectorised
# codegen): constants as its LLVM IR spells them
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2, _SQRTHF = -2.12194440e-4, 0.693359375, 0.707106781186547524
_MIN_NORM = 1.1754943508222875e-38


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of a float32 tensor bit for bit as XLA's CPU backend
    computes it: the exponent split, the sqrt(1/2) fold and the degree-8
    polynomial in three interleaved Horner chains, with ten of its
    multiply-adds fused exactly where the compiled code fuses them
    (:func:`_fma32`); 0 and a subnormal (read as 0) give -inf, +inf gives
    +inf, a negative or NaN input NaN."""
    f32 = torch.float32
    x = x.to(f32)
    c = {i: torch.tensor(v, dtype=f32, device=x.device) for i, v in enumerate(_LOG_P)}
    xm = torch.clamp(x, min=_MIN_NORM)
    b = xm.view(torch.int32)
    e = ((b >> 23) - 127).to(f32) + 1.0
    m = ((b & -2139095041) | 0x3F000000).view(f32)
    below = m < torch.tensor(_SQRTHF, dtype=f32)
    t = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(f32)
    t2 = t * t
    t3 = t2 * t
    y = _fma32(_fma32(c[0], t, c[1]), t, c[2])
    y1 = _fma32(_fma32(c[3], t, c[4]), t, c[5])
    y1 = _fma32(y, t3, y1)
    y2 = _fma32(_fma32(c[6], t, c[7]), t, c[8])
    y = _fma32(t3, y1, y2)
    q1e = torch.tensor(_LOG_Q1, dtype=f32, device=x.device) * e
    y = _fma32(y, t3, q1e)
    r = _fma32(torch.tensor(-0.5, dtype=f32, device=x.device), t2, t) + y
    r = _fma32(torch.tensor(_LOG_Q2, dtype=f32, device=x.device), e, r)
    r = torch.where((x <= 0) | torch.isnan(x), torch.full_like(r, float("nan")), r)
    r = torch.where(x == float("inf"), torch.full_like(r, float("inf")), r)
    # XLA's CPU code reads subnormals as zero (denormals-are-zero)
    return torch.where(x.abs() < _MIN_NORM, torch.full_like(r, float("-inf")), r)


_GUMBEL_TABLES: dict = {}


def gumbel_table(device) -> torch.Tensor:
    """The (2^23,) float32 table of every value ``gumbel`` can draw: entry
    ``j`` is ``-log(-log(u))`` for ``u = max(tiny, j * 2^-23 + tiny)``, the
    uniform of a draw whose ``bits >> 9`` is ``j``. Built once a device."""
    dev = torch.device(device)
    key_ = str(dev)
    if key_ not in _GUMBEL_TABLES:
        j = torch.arange(1 << 23, dtype=torch.int32, device=dev)
        u = _bounded((j | 0x3F800000).view(torch.float32) - 1.0, _MIN_NORM, 1.0)
        _GUMBEL_TABLES[key_] = -xla_log(-xla_log(u))
    return _GUMBEL_TABLES[key_]


def gumbel(k: torch.Tensor, shape: tuple[int, ...], offset: int = 0, row_stride: int | None = None) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, float32)`` ("low" mode); ``offset``
    and ``row_stride`` as :func:`bits` takes them. One threefry draw and
    one gather from :func:`gumbel_table`."""
    return gumbel_table(k.device)[bits(k, shape, offset, row_stride) >> 9]


def _int_bound(v, dev) -> torch.Tensor:
    """A randint bound as a 0-d int64 tensor on ``dev``: a Python number is
    filled in place there (a copy of host memory to the card would wait for
    the card's queue to drain)."""
    if torch.is_tensor(v):
        return v.to(device=dev, dtype=torch.int64)
    # graftlint: disable=round-host-sync -- v is a Python number on this branch (a tensor bound returned above)
    return torch.full((), int(v), dtype=torch.int64, device=dev)


def randint(k: torch.Tensor, shape: tuple[int, ...], minval, maxval, offset: int = 0,
            row_stride: int | None = None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32 result).
    ``minval`` and ``maxval`` are ints or 0-d tensors on the key's device
    (a tensor bound stays on the device: no host synchronisation). With
    ``offset`` (and ``row_stride``), the block of a larger draw
    :func:`bits` takes: both of its ``bits`` draws take them."""
    dev = k.device
    lo, hi = _int_bound(minval, dev), _int_bound(maxval, dev)
    k1, k2 = split(k)
    hi_bits, lo_bits = bits(k1, shape, offset, row_stride), bits(k2, shape, offset, row_stride)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _M32)
    mult = (65536 % span) * (65536 % span) & _M32
    mult = mult % span
    off = ((hi_bits % span) * mult & _M32) + lo_bits % span
    off = (off & _M32) % span
    return (lo + off).to(torch.int32)


# XLA's CPU log1p (its elemental emitter): log(1 + x) past sqrt(2) - 1,
# else the Cephes rational x - x^2/2 + x^3 P(x)/Q(x), highest power first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
            2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
            3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of a float32 tensor as XLA's CPU backend computes it:
    :func:`xla_log` of ``1 + x`` where ``|x| >= sqrt(2) - 1``, else
    ``x + fma(x^2, -0.5, x^3 * P(x) / Q(x))`` with both polynomials in
    Horner form, each step after the first a fused multiply-add (the first
    is ``x * 0 + c``, two roundings, as the compiled code keeps it)."""
    x = x.to(torch.float32)
    big = xla_log(x + 1.0)
    zero = x * 0.0

    def horner(coeffs):
        r = zero + _f32(coeffs[0], x)
        for c in coeffs[1:]:
            r = _fma32(r, x, _f32(c, x))
        return r

    x2 = x * x
    small = x + _fma32(x2, _f32(-0.5, x), (x * x2) * (horner(_LOG1P_P) / horner(_LOG1P_Q)))
    return torch.where(x.abs() < _f32(0.41421356237309504880, x), small, big)


# the Lanczos approximation XLA decomposes lgamma into (g = 7): the base
# coefficient rounds to 1.0 in float32
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)
_LOG_PI, _LOG_SQRT_2PI, _LOG_LANCZOS_HALF = 1.1447298858494002, 0.91893853320467274178, 2.0149030205422647


def _lgamma_z(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``lgamma(x)`` given ``z``, the Lanczos argument
    ``x - 1`` (the caller's: inside ``jax.random.poisson`` the compiled
    program folds ``(k + 1) - 1`` to ``k``). For ``x >= 0.5``:
    ``a = 1 + sum(c_i / (z + i))`` left to right, ``log t = log1p(z *
    float32(1/7.5)) + log(7.5)`` and ``fma((z + 0.5) - (z + 7.5) / log t,
    log t, log(sqrt(2 pi))) + log(a)``, exactly as compiled. Below 0.5
    the reflection ``log(pi) - log|sin(pi frac|x|)| - lgamma(1 - x)``,
    whose ``sin`` is torch's, not XLA's: exact wherever ``x >= 0.5``."""
    reflect = x < 0.5
    zz = torch.where(reflect, -x, z)
    acc = None
    for i, c in enumerate(_LANCZOS, start=1):
        # graftlint: disable=round-host-sync -- i is the host loop index over the Lanczos table
        q = _f32(c, x) / (zz + float(i))
        acc = q + 1.0 if acc is None else acc + q
    log_t = xla_log1p(zz * _f32(1.0 / 7.5, x)) + _f32(_LOG_LANCZOS_HALF, x)
    main = _fma32((zz + 0.5) - (zz + 7.5) / log_t, log_t, _f32(_LOG_SQRT_2PI, x)) + xla_log(acc)
    ax = x.abs()
    frac = ax - torch.floor(ax)
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    denom = xla_log(torch.sin(_f32(3.141592653589793, x) * frac))
    refl = torch.where(torch.isfinite(denom), (_f32(_LOG_PI, x) - denom) - main, -denom)
    out = torch.where(reflect, refl, main)
    return torch.where(torch.isinf(x), torch.full_like(out, float("inf")), out)


def lgamma32(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.lgamma`` of a float32 tensor bit for bit as XLA's CPU
    backend computes it for ``x >= 0.5`` (:func:`_lgamma_z` with ``z = x -
    1``); not ``torch.lgamma``, which differs on about half of the integers
    below 2^24, nor the correctly rounded value."""
    x = x.to(torch.float32)
    return _lgamma_z(x, x - 1.0)


def _key_rows(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``split`` of each of the (B, 2) ``keys``: (B, num, 2)."""
    kk = keys.T[:, :, None]
    y0, y1 = threefry2x32(kk, *_counters(keys, num))
    return torch.stack([y0, y1], dim=-1)


def _uniform_rows(keys: torch.Tensor) -> torch.Tensor:
    """One float32 ``uniform`` on [0, 1) per (B, 2) key (counter 0)."""
    z = torch.zeros((1,), dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys.T[:, :, None], z, z)
    b = ((y0 ^ y1)[:, 0] >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0


def _poisson_knuth(keys: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Knuth's loop a lane: split, count, add the log of a uniform, while
    the float32 log product stays above ``-lam``; the count less one."""
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    going = log_prod > -lam
    # graftlint: disable=round-host-sync -- Knuth's loop ends on the host an iteration, as the scalar while_loop does (the stream's arrival count is drawn on a host key)
    while bool(going.any()):
        rows = _key_rows(keys, 2)
        keys, sub = rows[:, 0], rows[:, 1]
        k = torch.where(going, k + 1, k)
        log_prod = log_prod + xla_log(_uniform_rows(sub))
        going = log_prod > -lam
    return k - 1


def _poisson_rejection(keys: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Hormann's transformed rejection a lane, as compiled: ``b =
    fma(sqrt(lam), 2.53, 0.931)``, ``a = fma(b, 0.02483, -0.059)``, then a
    three-way split an iteration, ``k = floor(fma(2a / us + b, u, lam) +
    0.43)``, ``s = log(v inv_alpha / (a / us^2 + b))`` and ``t = fma(k,
    log lam, -lam) - lgamma(k + 1)``; each lane keeps its first accepted
    ``k``."""
    f = lambda v: _f32(v, lam)  # noqa: E731
    log_lam = xla_log(lam)
    b = _fma32(torch.sqrt(lam), f(2.53), f(0.931))
    a = _fma32(b, f(0.02483), f(-0.059))
    inv_alpha = f(1.1239) + f(1.1328) / (b - f(3.4))
    v_r = f(0.9277) - f(3.6224) / (b - 2.0)
    two_a = a * 2.0
    k_out = torch.full_like(lam, -1.0)
    done = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    # graftlint: disable=round-host-sync -- the rejection loop ends on the host an iteration, as the scalar while_loop does
    while not bool(done.all()):
        rows = _key_rows(keys, 3)
        keys = rows[:, 0]
        u = _uniform_rows(rows[:, 1]) - 0.5
        v = _uniform_rows(rows[:, 2])
        us = 0.5 - u.abs()
        k = torch.floor(_fma32(two_a / us + b, u, lam) + f(0.43))
        s = xla_log(v * inv_alpha / (a / (us * us) + b))
        t = _fma32(k, log_lam, -lam) - _lgamma_z(k + 1.0, k)
        accept1 = (us >= f(0.07)) & (v <= v_r)
        reject = (k < 0) | ((us < f(0.013)) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept & ~done, k, k_out)
        done = done | accept
    return k_out


def poisson(k: torch.Tensor, lam, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.poisson(k, lam, dtype=int32)`` with a scalar shape: one
    draw a key, ``k`` a key (2,) or a batch of keys (B, 2) beside ``lam``
    (B,) float32 rates (a Python float is rounded to float32). Knuth's
    branch where ``lam < 10``, the rejection branch elsewhere, 0 where
    ``lam == 0``; each lane's loop runs until it ends, as the scalar
    ``while_loop`` does (on a CUDA key the loop condition is read on the
    host an iteration)."""
    single = k.dim() == 1
    keys = k.reshape(-1, 2)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=keys.device).reshape(-1).expand(keys.shape[0])
    knuth = torch.isnan(lam) | (lam < 10)
    out = torch.zeros(lam.shape, dtype=torch.int64, device=keys.device)
    # graftlint: disable=round-host-sync -- the branch split is picked on the host; the stream draws its Poisson count on a host key
    if bool(knuth.any()):
        idx = torch.nonzero(knuth).reshape(-1)
        out[idx] = _poisson_knuth(keys[idx], lam[idx]).to(torch.int64)
    # graftlint: disable=round-host-sync -- the branch split is picked on the host; the stream draws its Poisson count on a host key
    if not bool(knuth.all()):
        idx = torch.nonzero(~knuth).reshape(-1)
        out[idx] = _poisson_rejection(keys[idx], lam[idx]).to(torch.int64)
    out = torch.where(lam == 0, torch.zeros_like(out), out).to(dtype)
    return out[0] if single else out
