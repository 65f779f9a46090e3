"""JAX's threefry random streams in torch: the subset of ``jax.random`` that
the on-device window functions (``data.traces``) draw from.

Every function returns the same bits as its ``jax.random`` namesake on the
same key, on the CPU and on the card alike:

* keys are ``int64[..., 2]`` tensors holding the two uint32 words of a JAX
  threefry key (torch has only partial uint32 support, so all 32-bit
  arithmetic runs in int64 and is masked after every add and shift);
* leading key dimensions batch, as ``jax.vmap`` over keys does: a key of
  shape ``[G, 2]`` and a sample shape ``S`` give ``[G, *S]``;
* ``partitionable`` selects JAX's bit layout (``jax_threefry_partitionable``,
  True by default since jax 0.5; False before), which changes ``split``,
  ``random_bits`` and everything drawn from them, never ``fold_in``.

The float samplers reproduce XLA's CPU code op by op, from exactly rounded
operations only (add, multiply, divide and square root of float32 values
computed in float64 and rounded once, which is exact; a fused multiply-add
emulated with an exact product and a round-to-odd sum; every divisor a
tensor, since PyTorch's CUDA division by a scalar multiplies by its
reciprocal): ``uniform`` is a
bit-level construction, ``normal`` is XLA's ``ErfInv`` polynomial over its
own ``log`` / ``log1p`` sequences, and :func:`powf` is the float32 ``pow``
XLA's CPU backend calls (glibc's, from ARM's optimized-routines). So no
result depends on the device's ``erfinv``, ``log1p`` or ``pow``.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

from repro_torch.kernels import runtime

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    return x & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pair ``(x0, x1)``
    under ``key`` (``int64[..., 2]``, its words broadcast against the
    counts). Returns the two output words as int64 tensors in ``[0,
    2**32)``."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = _u32(x0 + ks[0])
    x1 = _u32(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = _u32(x0 + x1)
            x1 = x0 ^ _rotl(x1, r)
        x0 = _u32(x0 + ks[(i + 1) % 3])
        x1 = _u32(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def PRNGKey(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey`` of a 32-bit seed (an int or an integer tensor,
    which batches): ``[0, seed mod 2**32]``, on ``device`` (CUDA unless
    named)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=runtime.resolve_device(device))
    return torch.stack([torch.zeros_like(s), _u32(s)], dim=-1)


threefry_seed = PRNGKey


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair ``(0, data mod
    2**32)``; the same in both layouts. ``data`` may be a tensor; it
    broadcasts against the key's batch dimensions."""
    d = _u32(torch.as_tensor(data, dtype=torch.int64, device=key.device))
    d = d.expand(torch.broadcast_shapes(key.shape[:-1], d.shape))
    o0, o1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def _counts(n: int, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def _hash_flat(key: torch.Tensor, n: int, partitionable: bool):
    """The ``n`` uint32 words JAX hashes out of ``key`` for ``n`` 32-bit
    draws: the two words of the hash of the flat index (partitionable), or
    threefry over ``iota(n)`` split in halves (the original layout)."""
    c = _counts(n, key.device)
    key = key.unsqueeze(-2)  # batch dimensions before the counts'
    if partitionable:
        o0, o1 = threefry2x32(key, c >> 32, c & M32)
        return o0 ^ o1
    half = (n + 1) // 2
    pad = torch.cat([c, c.new_zeros(2 * half - n)])  # odd sizes pad one 0
    o0, o1 = threefry2x32(key, pad[:half], pad[half:])
    return torch.cat([o0, o1], dim=-1)[..., :n]


def split(key: torch.Tensor, num: int = 2, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split``: ``int64[..., num, 2]``."""
    c = _counts(num, key.device)
    if partitionable:
        o0, o1 = threefry2x32(key.unsqueeze(-2), c >> 32, c & M32)
        return torch.stack([o0, o1], dim=-1)
    words = _hash_flat(key, 2 * num, partitionable=False)
    return words.reshape(tuple(key.shape[:-1]) + (num, 2))


def random_bits(key: torch.Tensor, shape=(), partitionable: bool = True) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``int64[..., *shape]`` in ``[0, 2**32)``."""
    shape = tuple(shape)
    n = math.prod(shape)
    return _hash_flat(key, n, partitionable).reshape(tuple(key.shape[:-1]) + shape)


def _bound(x, key: torch.Tensor, n_dims: int) -> torch.Tensor:
    """A bound (a scalar, or one value per key) shaped to broadcast against
    a ``[*batch, *shape]`` sample of ``n_dims`` sample dimensions."""
    t = torch.as_tensor(x, dtype=torch.int64, device=key.device)
    return t.reshape(t.shape + (1,) * n_dims) if t.dim() else t


def randint(key: torch.Tensor, shape, minval, maxval, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit draws combined by
    multiply-and-mod, with JAX's uint32 wraps (for spans above 2**16 the
    multiplier wraps to 0, so only the second draw counts). ``minval`` /
    ``maxval`` are int32 values, scalars or one per key."""
    shape = tuple(shape)
    keys = split(key, 2, partitionable)
    hi = random_bits(keys[..., 0, :], shape, partitionable)
    lo = random_bits(keys[..., 1, :], shape, partitionable)
    lo_v, hi_v = _bound(minval, key, len(shape)), _bound(maxval, key, len(shape))
    span = torch.where(hi_v <= lo_v, 1, _u32(hi_v - lo_v))
    mult = (65536 % span)
    mult = _u32(mult * mult) % span
    off = _u32(_u32((hi % span) * mult) + lo % span) % span
    return wrap_i32(lo_v + off).to(torch.int32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's two's-complement range (the wrap of
    int32 arithmetic, made explicit)."""
    return ((x + 2**31) & M32) - 2**31


# --------------------------------------------------------------------------
# exactly rounded float32 arithmetic, carried in float64
# --------------------------------------------------------------------------
def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32, kept as float64. A float32 add,
    subtract, multiply, divide or square root computed in float64 and
    rounded once here is the exactly rounded float32 result."""
    return x.to(torch.float32).to(torch.float64)


def _c(h: str) -> float:
    """A float32 constant from the hex of its float64 form (as XLA's LLVM
    IR prints it)."""
    return struct.unpack(">d", bytes.fromhex(h))[0]


def _two_sum(a: torch.Tensor, b):
    """``s = fl(a + b)`` and its exact error ``a + b - s`` (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``s + e`` (``e`` the exact error of ``s``) rounded to odd: ``s`` when
    exact or odd, else its neighbour towards ``e``. Rounding a round-to-odd
    float64 to float32 rounds the exact value once (Boldo and Melquiond)."""
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((e != 0) & even, torch.nextafter(s, e * math.inf), s)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` of float32 values carried in float64 (``b``
    and ``c`` tensors or floats): the product is exact, the sum is rounded
    to odd and then to float32."""
    s, e = _two_sum(a * b, c)
    return _f32(_round_odd(s, e))


def _two_prod(a: torch.Tensor, b):
    """``p = fl(a * b)`` and its exact error (Dekker, Veltkamp's split)."""
    def halves(x):
        t = x * 134217729.0  # 2**27 + 1
        hi = t - (t - x)
        return hi, x - hi

    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 ``fma(a, b, c)`` (Boldo and Melquiond's emulation: exact
    product, exact sum with ``c``, the two low parts added rounded to odd,
    one final rounding)."""
    ph, pl = _two_prod(a, b)
    th, tl = _two_sum(torch.as_tensor(c, dtype=torch.float64, device=a.device), ph)
    v = _round_odd(*_two_sum(tl, pl))
    return th + v


# --------------------------------------------------------------------------
# uniform / normal
# --------------------------------------------------------------------------
def _unit_floats(key, shape, partitionable) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the high 23 bits (as float64)."""
    bits = random_bits(key, shape, partitionable)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f.to(torch.float64) - 1.0  # exact


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``max(lo, fma(f, hi - lo, lo))``
    (XLA fuses the scale and shift into one multiply-add)."""
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    u = _fma32(_unit_floats(key, shape, partitionable), span, lo)
    return torch.clamp(u, min=lo).to(torch.float32)


# XLA's float32 log (its CPU polynomial), log1p (Cephes' rational form for
# |x| < sqrt(2) - 1) and ErfInv (Giles' polynomials), constants as float32
_LOG = dict(
    sqrt_half=_c("3FE6A09E60000000"),
    p=[_c(h) for h in (
        "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000", "3FC23D37E0000000",
        "3FC999D580000000", "BFCFFFFF80000000", "3FBDE4A340000000", "BFC555CA00000000",
        "3FD5555540000000")],
    q1=_c("BF2BD01060000000"), q2=_c("3FE6300000000000"),
)
_LOG1P_DEN = [_c(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000", "4073519460000000",
    "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM = [_c(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
    "404E798EC0000000", "404C8E75A0000000", "40340A2020000000")]
_LOG1P_SMALL = _c("3FDA8279A0000000")
_ERFINV_LT5 = [_c(h) for h in (
    "3E5E2CB100000000", "3E970966C0000000", "BECD8E6AE0000000", "BED26B5820000000",
    "3F2CA65B60000000", "BF548A8100000000", "BF711C9DE0000000", "3FCF91EC60000000",
    "3FF805C5E0000000")]
_ERFINV_GE5 = [_c(h) for h in (
    "BF2A3E1360000000", "3F1A76AD60000000", "3F561B8E40000000", "BF6E17BCE0000000",
    "3F77824F60000000", "BF7F38BAE0000000", "3F8354AFC0000000", "3FF006DB60000000",
    "4006A9EFC0000000")]
_SQRT2 = _c("3FF6A09E60000000")
_MIN_NORMAL = 2.0 ** -126


def _xla_log(z: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log for positive finite ``z`` (float32 values carried
    in float64): split off the exponent, keep the mantissa near 1, then
    the polynomial with the multiply-adds its CPU code fuses."""
    bits = torch.clamp(z, min=_MIN_NORMAL).to(torch.float32).view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 127).to(torch.float64) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32).to(torch.float64)
    small = m < _LOG["sqrt_half"]
    e = torch.where(small, e - 1.0, e)
    r = (m - 1.0) + torch.where(small, m, 0.0)  # exact
    r2 = _f32(r * r)
    r3 = _f32(r2 * r)
    p = _LOG["p"]
    a = _fma32(_fma32(r, p[0], p[1]), r, p[6])
    b = _fma32(_fma32(r, p[2], p[3]), r, p[7])
    c = _fma32(_fma32(r, p[4], p[5]), r, p[8])
    poly = _fma32(_fma32(a, r3, b), r3, c)
    tail = _fma32(poly, r3, _f32(e * _LOG["q1"]))
    head = _fma32(r2, -0.5, r)
    return _fma32(e, _LOG["q2"], _f32(head + tail))


def _xla_log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: the rational form below sqrt(2) - 1 in
    magnitude, ``log(1 + y)`` above."""
    y2 = _f32(y * y)
    den = torch.ones_like(y)
    for k in _LOG1P_DEN:
        den = _fma32(den, y, k)
    num = torch.full_like(y, _LOG1P_NUM[0])
    for k in _LOG1P_NUM[1:]:
        num = _fma32(num, y, k)
    q = _f32(num / den)
    s = _f32(_f32(y * y2) * q)
    small = _f32(y + _fma32(y2, -0.5, s))
    return torch.where(y.abs() < _LOG1P_SMALL, small, _xla_log(_f32(y + 1.0)))


def _xla_erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv for |u| < 1 (float32 values in float64):
    ``w = -log1p(-u*u)``, Giles' polynomial in ``w - 2.5`` or
    ``sqrt(w) - 3``, Horner steps fused, times ``u``."""
    lg = _xla_log1p(_f32(u * -u))
    lt = lg > -5.0
    t = torch.where(lt, _f32(-2.5 - lg), _f32(_f32(torch.sqrt(-lg)) - 3.0))
    cf = [torch.where(lt, a, b) for a, b in zip(
        torch.tensor(_ERFINV_LT5, dtype=torch.float64, device=u.device),
        torch.tensor(_ERFINV_GE5, dtype=torch.float64, device=u.device))]
    p = cf[0]
    for k in cf[1:]:
        p = _fma32(p, t, k)
    p = torch.where(u.abs() == 1.0, math.inf, p)
    return _f32(u * p)


def normal(key: torch.Tensor, shape=(), partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0,
                partitionable).to(torch.float64)
    return _f32(_xla_erf_inv(u) * _SQRT2).to(torch.float32)


# --------------------------------------------------------------------------
# float32 pow (glibc's powf, which XLA's CPU backend calls)
# --------------------------------------------------------------------------
_POWF_LOG2_TAB = [float.fromhex(h) for h in (
    "0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2", "0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2",
    "0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2", "0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2",
    "0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2", "0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3",
    "0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3", "0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4",
    "0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5", "0x1.0000000000000p+0", "0x0.0p+0",
    "0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4", "0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3",
    "0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3", "0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2",
    "0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2", "0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2")]
_POWF_LOG2_POLY = [float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_EXP2F_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2F_SHIFT = float.fromhex("0x1.8p+47")
_EXP2F_POLY = [float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y`` as glibc's ``powf`` computes it (the FMA build, a
    table-driven log2 and exp2 in float64), for positive normal ``x`` and
    ``|y * log2(x)| < 126`` -- the range ``zipf_window`` draws from."""
    dev = x.device
    ix = x.to(torch.float32).view(torch.int32).to(torch.int64)
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    k = tmp >> 23
    iz = _u32(ix - (k << 23))
    tab = torch.tensor(_POWF_LOG2_TAB, dtype=torch.float64, device=dev).reshape(16, 2)
    invc, logc = tab[i, 0], tab[i, 1]
    z = iz.to(torch.int32).view(torch.float32).to(torch.float64)
    A = _POWF_LOG2_POLY
    r = _fma64(z, invc, -1.0)
    y0 = logc + k.to(torch.float64)
    r2 = r * r
    p = _fma64(r, A[0], A[1])
    q = _fma64(r, A[2], A[3])
    r4 = r2 * r2
    q0 = _fma64(r, A[4], y0)
    q0 = _fma64(r2, q, q0)
    logx = _fma64(p, r4, q0)
    ylogx = float(np.float32(y)) * logx
    kd = ylogx + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2F_SHIFT
    rr = ylogx - kd
    m = ki - struct.unpack("<q", struct.pack("<d", _EXP2F_SHIFT))[0]
    t = torch.tensor(_EXP2F_TAB, dtype=torch.int64, device=dev)[m & 31] + (m << 47)
    s = t.view(torch.float64)
    C = _EXP2F_POLY
    zz = _fma64(rr, C[0], C[1])
    rr2 = rr * rr
    yy = _fma64(rr, C[2], 1.0)
    yy = _fma64(zz, rr2, yy)
    return (yy * s).to(torch.float32)


# --------------------------------------------------------------------------
# permutation
# --------------------------------------------------------------------------
def permutation(key: torch.Tensor, n: int, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int32: ``ceil(3 ln n / ln
    (2**32 - 1))`` rounds of a stable sort of ``arange(n)`` on fresh
    32-bit keys, each round's key split off the last."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(*key.shape[:-1], n)
    for _ in range(rounds):
        keys = split(key, 2, partitionable)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,), partitionable), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.to(torch.int32)


# --------------------------------------------------------------------------
# binomial (jax.random.binomial: inversion and BTRS rejection loops)
# --------------------------------------------------------------------------
def _bits_at(key: torch.Tensor, idx: torch.Tensor, n: int, partitionable: bool) -> torch.Tensor:
    """The words ``random_bits(key, (n,))`` holds at flat positions ``idx``
    (one key), without hashing the other positions: a position's word
    depends only on its own threefry counter."""
    if partitionable:
        o0, o1 = threefry2x32(key, idx >> 32, idx & M32)
        return o0 ^ o1
    half = (n + 1) // 2
    low = idx < half  # the first half takes word 0 of the pair (i, i + half)
    x0 = torch.where(low, idx, idx - half)
    x1 = torch.where(low, idx + half, idx)
    x1 = torch.where(x1 < n, x1, 0)  # an odd size pads the last pair with 0
    o0, o1 = threefry2x32(key, x0, x1)
    return torch.where(low, o0, o1)


def _uniform_at(key: torch.Tensor, idx: torch.Tensor, n: int, partitionable: bool) -> torch.Tensor:
    """``uniform(key, (n,))[idx]`` on [0, 1), as float64 (exact)."""
    f = ((_bits_at(key, idx, n, partitionable) >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32).to(torch.float64) - 1.0


def _div(a, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a / b`` (float32 values carried in float64), the numerator
    made a tensor: torch's ``scalar / tensor`` is a reciprocal and a
    multiply, two roundings."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return _f32(a / b)


def _k(x: float) -> float:
    """A Python constant as the float32 value XLA folds it to."""
    return float(np.float32(x))


def _fma32_x(a: torch.Tensor, b, c) -> torch.Tensor:
    """:func:`_fma32` for the binomial, whose operands can be infinite: an
    infinite or NaN sum passes through."""
    s, e = _two_sum(a * b, c)
    return _f32(torch.where(torch.isfinite(s), _round_odd(s, e), s))


def _log_x(z: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log over its whole range, as :func:`_xla_log` with
    XLA's edges (its CPU code runs with subnormals flushed to zero): +-0
    and subnormals give -inf, +inf gives +inf, a negative or NaN argument
    NaN. The binomial's ``u = 0`` draws and its bound's terms reach them."""
    out = _xla_log(z)
    out = torch.where((z < 0) | torch.isnan(z), math.nan, out)
    out = torch.where(z == math.inf, math.inf, out)
    return torch.where(z.abs() < _MIN_NORMAL, -math.inf, out)


# _stirling_approx_tail's table and its weak-typed constants as float32
_STIRLING_TAIL = [_k(v) for v in (
    0.0810614667953272, 0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
    0.0166446911898211, 0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
    0.00925546218271273, 0.00833056343336287)]


def _stirling_tail(k: torch.Tensor) -> torch.Tensor:
    """jax's ``_stirling_approx_tail``: the table up to 9, else the series
    (every step a division: no multiply-add to fuse)."""
    use_tail = k <= 9
    kc = torch.clamp(k, 0.0, 9.0)
    kp1 = _f32(kc + 1.0)
    kp1sq = _f32(kp1 * kp1)
    approx = _div(_f32(_k(1.0 / 12) - _div(_f32(_k(1.0 / 360) - _div(_k(1.0 / 1260), kp1sq)),
                                          kp1sq)), kp1)
    tab = torch.tensor(_STIRLING_TAIL, dtype=torch.float64, device=k.device)
    row = torch.nan_to_num(torch.floor(kc), nan=0.0).long()
    return torch.where(use_tail, tab[row], approx)


def _binomial_inversion(key, count, q, idx, n, partitionable, stats):
    """jax's ``_binomial_inversion`` at flat positions ``idx`` of an
    ``n``-element draw: geometric gaps ``ceil(log(u) / log1p(-q))`` summed
    until they pass ``count``. An element's result depends only on its own
    draws, so each iteration hashes only the elements still below their
    count; the loop ends when none is (one device sync per iteration)."""
    log1m = _xla_log1p(-q)
    num_geom = torch.zeros_like(count)
    geom_sum = torch.zeros_like(count)
    iters = 0
    while True:
        live = (geom_sum <= count).nonzero(as_tuple=True)[0]
        if live.numel() == 0:
            break
        keys = split(key, 2, partitionable)
        sub, key = keys[0], keys[1]
        u = _uniform_at(sub, idx[live], n, partitionable)
        geom = torch.ceil(_f32(_log_x(u) / log1m[live]))
        num_geom[live] += 1.0
        geom_sum[live] = _f32(geom_sum[live] + geom)
        iters += 1
    if stats is not None:
        stats["inversion_iters"] = iters
        stats["host_syncs"] += iters + 1  # each iteration's nonzero, and the last
    return num_geom - 1.0


class _BtrsSetup:
    """BTRS's per-element constants (float32 values in float64), with the
    multiply-adds XLA's CPU code fuses: ``b``, the first two terms of
    ``a`` and ``c`` are FMAs; ``q * 0.01`` is a product of its own (LLVM
    hoists it out of the loop over elements)."""

    def __init__(self, count: torch.Tensor, q: torch.Tensor):
        self.count = count
        stddev = torch.sqrt(_f32(_f32(count * q) * _f32(1.0 - q)))
        self.b = b = _fma32_x(stddev, _k(2.53), _k(1.15))
        self.a = a = _f32(_fma32_x(b, _k(0.0248), _k(-0.0873)) + _f32(q * _k(0.01)))
        self.a2 = _f32(a * 2.0)
        self.c = _fma32_x(count, q, 0.5)
        self.v_r = _f32(_k(0.92) - _div(_k(4.2), b))
        self.r = r = _div(q, _f32(1.0 - q))
        self.alpha = _f32(_f32(_div(_k(5.1), b) + _k(2.83)) * stddev)
        self.m = m = torch.floor(_f32(_f32(count + 1.0) * q))
        self.cm1 = cm1 = _f32(_f32(count - m) + 1.0)
        self.t1 = _f32(_f32(m + 0.5) * _log_x(_div(_f32(m + 1.0), _f32(r * cm1))))
        self.count1 = _f32(count + 1.0)
        self.s_tail = (_stirling_tail(m), _stirling_tail(_f32(count - m)))


def _btrs_step(s: _BtrsSetup, u: torch.Tensor, v: torch.Tensor):
    """One BTRS proposal per element: ``(k, accept)``."""
    u = u - 0.5  # exact
    us = 0.5 - u.abs()
    accept1 = (us >= _k(0.07)) & (v <= s.v_r)
    k = torch.floor(_fma32_x(_f32(_div(s.a2, us) + s.b), u, s.c))
    reject = (k < 0) | (k > s.count)
    v = _log_x(_div(_f32(v * s.alpha), _f32(_div(s.a, _f32(us * us)) + s.b)))
    nk1 = _f32(_f32(s.count - k) + 1.0)
    ub = _fma32_x(s.count1, _log_x(_div(s.cm1, nk1)), s.t1)
    ub = _fma32_x(_f32(k + 0.5), _log_x(_div(_f32(s.r * nk1), _f32(k + 1.0))), ub)
    ub = _f32(_f32(ub + s.s_tail[0]) + s.s_tail[1])
    ub = _f32(_f32(ub - _stirling_tail(k)) - _stirling_tail(_f32(s.count - k)))
    return k, accept1 | (~reject & (v <= ub))


def _btrs(key, count, q, idx, dummy_idx, n, partitionable, stats):
    """jax's ``_btrs`` at flat positions ``idx``. Unlike the inversion, an
    element's result depends on how long the loop runs: every accepted
    proposal overwrites the last, and the reference's loop runs until every
    element of the draw has accepted once -- the elements that take the
    inversion too, which it runs at count 1e4, q 0.5 (``dummy_idx``). So
    the real elements propose in every iteration, and the placeholders
    until each has accepted once (their results are never used)."""
    real = _BtrsSetup(count, q)
    one = torch.ones(1, dtype=torch.float64, device=count.device)
    dummy = _BtrsSetup(one * 1e4, one * 0.5)
    k_out = torch.full_like(count, -1.0)
    accepted = torch.zeros_like(count, dtype=torch.bool)
    pending = dummy_idx
    iters = dummy_props = syncs = 0
    while True:
        syncs += 1
        # one device sync per iteration: is any element still unaccepted?
        if not bool((~accepted).any()) and pending.numel() == 0:
            break
        keys = split(key, 3, partitionable)
        key, sub0, sub1 = keys[0], keys[1], keys[2]
        k, accept = _btrs_step(real, _uniform_at(sub0, idx, n, partitionable),
                               _uniform_at(sub1, idx, n, partitionable))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
        if pending.numel():
            syncs += 1  # the compaction
            dummy_props += pending.numel()
            _, acc = _btrs_step(dummy, _uniform_at(sub0, pending, n, partitionable),
                                _uniform_at(sub1, pending, n, partitionable))
            pending = pending[~acc]
        iters += 1
    if stats is not None:
        stats["btrs_iters"] = iters
        stats["placeholder_proposals"] = dummy_props
        stats["host_syncs"] += syncs
    return k_out


def binomial(key: torch.Tensor, count, prob, shape=None, dtype=torch.float32,
             partitionable: bool = True, stats: dict | None = None) -> torch.Tensor:
    """``jax.random.binomial(key, count, prob, shape, dtype)`` for one key
    (``int64[2]``), bit for bit: the inversion where ``count * q <= 10``
    (``q = min(prob, 1 - prob)``), BTRS elsewhere, reflected for ``prob >=
    0.5``; NaN for a NaN or negative count or an invalid ``prob``, inf for
    an infinite count. Counts are float32 values (cast if given otherwise).

    ``stats``, when a dict, receives the loops' iteration counts, the
    elements on each branch, the placeholder proposals BTRS made and the
    device-to-host syncs of the call (each loop iteration reads back whether
    any element is still live)."""
    dev = key.device
    count = torch.as_tensor(count, device=dev).to(torch.float32).to(torch.float64)
    prob = torch.as_tensor(prob, device=dev).to(torch.float32).to(torch.float64)
    bshape = torch.broadcast_shapes(count.shape, prob.shape)
    shape = bshape if shape is None else tuple(shape)
    try:
        fits = torch.broadcast_shapes(bshape, shape) == torch.Size(shape)
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(
            f"binomial: shape {shape} does not broadcast count {tuple(count.shape)} "
            f"and prob {tuple(prob.shape)}")
    count = count.expand(shape).reshape(-1)
    prob = prob.expand(shape).reshape(-1)
    n = count.numel()
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, _f32(1.0 - prob))
    count_nan_or_neg = torch.isnan(count) | (count < 0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0
    q = torch.where(q_is_nan | q_l_0, _k(0.01), q)
    use_inversion = count_nan_or_neg | (_f32(count * q) <= 10.0)
    count = torch.floor(count)
    if stats is not None:
        stats.update(inversion_iters=0, btrs_iters=0, placeholder_proposals=0,
                     host_syncs=2)  # the two nonzeros below
    inv_idx = use_inversion.nonzero(as_tuple=True)[0]
    btrs_idx = (~use_inversion).nonzero(as_tuple=True)[0]
    samples = torch.zeros_like(count)
    if inv_idx.numel():
        samples[inv_idx] = _binomial_inversion(
            key, count[inv_idx], q[inv_idx], inv_idx, n, partitionable, stats)
    if btrs_idx.numel():
        samples[btrs_idx] = _btrs(key, count[btrs_idx], q[btrs_idx], btrs_idx,
                                  inv_idx, n, partitionable, stats)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, math.nan, samples)
    samples = torch.where(count_inf & ~invalid, math.inf, samples)
    keep = p_lt_half | count_nan_or_neg | q_is_nan | count_inf
    samples = torch.where(keep, samples, _f32(count - samples))
    if stats is not None:
        stats.update(inversion_elements=inv_idx.numel(), btrs_elements=btrs_idx.numel())
    return samples.reshape(shape).to(dtype)
