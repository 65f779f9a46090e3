"""The port's threefry streams (``repro_torch.data.prng``) against
``jax.random``, bit for bit, on the CPU.

Each test runs in the bit layout the installed jax uses
(``jax_threefry_partitionable``), passed through to the port; one test also
runs the other layout, switching jax's flag for its duration. Float draws
are compared as bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro_torch.data import prng  # noqa: E402

SEEDS = (0, 7, -3, 2**31 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (1000,))


def layout() -> bool:
    return bool(jax.config.jax_threefry_partitionable)


def key_pair(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def same(ref, got: torch.Tensor, what: str = "") -> None:
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:
        ref = ref.astype(np.int64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    assert ref.dtype == got.dtype, (what, ref.dtype, got.dtype)
    assert np.array_equal(ref.reshape(-1).view(np.uint8), got.reshape(-1).view(np.uint8)), what


def test_key_fold_in_and_threefry():
    from jax._src import prng as jprng

    for seed in SEEDS:
        jk, k = key_pair(seed)
        same(jk, k, "PRNGKey")
        for d in (0, 5, 2**32 - 1):
            same(jax.random.fold_in(jk, d), prng.fold_in(k, d), f"fold_in {d}")
        # jax hashes the two halves of the counts as (x0, x1) pairs
        ref = jprng.threefry_2x32(jk, np.arange(10, dtype=np.uint32))
        o0, o1 = prng.threefry2x32(k, torch.arange(5), torch.arange(5, 10))
        same(ref, torch.cat([o0, o1]), "threefry2x32")


def test_split_and_random_bits():
    p = layout()
    for seed in SEEDS:
        jk, k = key_pair(seed)
        for num in (2, 3, 5):
            same(jax.random.split(jk, num), prng.split(k, num, p), f"split {num}")
        for shape in SHAPES:
            same(jax.random.bits(jk, shape, jnp.uint32), prng.random_bits(k, shape, p),
                 f"bits {shape}")


@pytest.mark.parametrize("bounds", [(3, 1000), (0, 3_000_000), (-50, 2**31 - 1), (9, 9), (5, 2)])
def test_randint(bounds):
    """Spans below and above 2**16 (where JAX's multiplier wraps to 0), the
    full positive range and empty ranges."""
    p = layout()
    for seed in SEEDS[:2]:
        jk, k = key_pair(seed)
        for shape in SHAPES:
            same(jax.random.randint(jk, shape, *bounds), prng.randint(k, shape, *bounds, p),
                 f"randint {bounds} {shape}")


def test_uniform():
    p = layout()
    for seed in SEEDS:
        jk, k = key_pair(seed)
        for lo, hi in ((0.0, 1.0), (1e-7, 1.0), (-3.5, 2.25)):
            for shape in SHAPES:
                same(jax.random.uniform(jk, shape, minval=lo, maxval=hi),
                     prng.uniform(k, shape, lo, hi, p), f"uniform {lo} {hi} {shape}")


def test_normal():
    """XLA's erf_inv over its log / log1p, rebuilt from exactly rounded
    operations: every one of 2 x 150,001 draws equal (an odd size)."""
    for seed in (0, 11):
        jk, k = key_pair(seed)
        ref = np.asarray(jax.random.normal(jk, (150_001,)))
        got = prng.normal(k, (150_001,), layout()).numpy()
        assert int((ref.view(np.int32) != got.view(np.int32)).sum()) == 0, seed


def test_powf_matches_jax_power():
    """float32 pow as XLA's CPU code computes it (glibc's powf), over the
    uniform draws zipf_window raises to -1 / (a - 1)."""
    u = jax.random.uniform(jax.random.PRNGKey(3), (300_000,), minval=1e-7, maxval=1.0)
    ref = np.asarray(u ** (-1.0 / (1.2 - 1.0)))
    got = prng.powf(torch.from_numpy(np.array(u)), -1.0 / (1.2 - 1.0)).numpy()
    assert int((ref.view(np.int32) != got.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("n", [1, 1001, 100_000, 2_700_000])
def test_permutation(n):
    """No, one, two and three sort rounds (three from n of about 2,642,000)."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2**32 - 1)))
    assert rounds == {1: 0, 1001: 1, 100_000: 2, 2_700_000: 3}[n]
    jk, k = key_pair(5)
    same(jax.random.permutation(jk, n), prng.permutation(k, n, layout()), f"perm {n}")


def test_batched_keys_equal_vmap():
    """Leading key dimensions batch as jax.vmap over keys does, with one
    bound per key."""
    p = layout()
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(1), s))(jnp.arange(4))
    keys = prng.fold_in(prng.PRNGKey(1, device="cpu"), torch.arange(4))
    same(jkeys, keys, "keys")
    maxval = np.array([3, 70_000, 1, 12], np.int32)
    same(jax.vmap(lambda k, m: jax.random.randint(k, (33,), 0, m))(jkeys, maxval),
         prng.randint(keys, (33,), 0, torch.from_numpy(maxval), p), "randint")
    same(jax.vmap(lambda k: jax.random.normal(k, (33,)))(jkeys), prng.normal(keys, (33,), p),
         "normal")
    same(jax.vmap(lambda k: jax.random.permutation(k, 77))(jkeys),
         prng.permutation(keys, 77, p), "permutation")


def test_other_layout():
    """The layout the installed jax does not default to, with jax's flag
    switched for the test."""
    p = not layout()
    try:
        jax.config.update("jax_threefry_partitionable", p)
        jk, k = key_pair(2)
        same(jax.random.split(jk, 3), prng.split(k, 3, p), "split")
        same(jax.random.bits(jk, (7,), jnp.uint32), prng.random_bits(k, (7,), p), "bits")
        same(jax.random.randint(jk, (9,), 0, 100_000), prng.randint(k, (9,), 0, 100_000, p),
             "randint")
        same(jax.random.normal(jk, (1001,)), prng.normal(k, (1001,), p), "normal")
        same(jax.random.permutation(jk, 1001), prng.permutation(k, 1001, p), "permutation")
    finally:
        jax.config.update("jax_threefry_partitionable", not p)


def test_keys_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.PRNGKey(0)
