"""The port's kernel registry at parity with the JAX package's, on the CPU:
the nine names, each entry's example (the same numpy draws in both
packages) through the port's plain version against the JAX reference and
the port's numpy oracle; the consolidation copies (K5a/K5b) bit for bit
against ``repro.kernels.consolidate`` under both JAX backends, Pallas in
interpret mode and ``xla``; GQA attention (K7) against
``gqa_attention(kernel_backend="xla")`` and a float64 numpy softmax; and
``tiered_lookup`` bit for bit.

The CUDA kernels run only on the card: the ``cuda``-marked test holds K5a,
K5b and K7 to their plain versions on edge cases there
(``python -m pytest -m cuda tests/test_torch_registry.py``, which needs no
JAX: the JAX package is imported by the fixture ``jx``), and
``chip_smoke.py``'s registry phase does so at full width.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.consolidate import ops as cons  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.tiered_lookup import ops as tl  # noqa: E402

JAX_BACKENDS = ("pallas", "xla")
# K7 against the JAX reference (tests/test_kernels.py's flash tolerances)
FA_TOL = {np.float32: 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel modules."""
    from repro.kernels import registry as jreg
    from repro.kernels.consolidate import ops as jcons
    from repro.kernels.flash_attention import ops as jfa
    from repro.kernels.tiered_lookup import ops as jtl

    return types.SimpleNamespace(reg=jreg, cons=jcons, fa=jfa, tl=jtl)


def t(a):
    """A torch copy of a numpy array (bfloat16 from float32 values)."""
    if isinstance(a, tuple):  # (float32 values, "bf16")
        return torch.from_numpy(np.array(a[0])).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def j(a):
    import jax.numpy as jnp

    return jnp.asarray(a[0], jnp.bfloat16) if isinstance(a, tuple) else jnp.asarray(a)


def bits(x) -> np.ndarray:
    """The raw bytes of a JAX or torch array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().view(np.uint8)
    x = np.asarray(x)
    return x.view(np.uint16).view(np.uint8) if x.dtype.name == "bfloat16" else x.view(np.uint8)


def assert_bits(got, want, what=""):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    assert np.array_equal(bits(got), bits(want)), what


def payload(r, shape, dtype):
    x = r.standard_normal(shape).astype(np.float32)
    return (x, "bf16") if dtype == "bfloat16" else x


# --------------------------------------------------------------------------
# K5a / K5b: the consolidation copies
# --------------------------------------------------------------------------
def region_cases(r):
    """(n_rows, elems, ids): -1 padding at the end (a region's usual shape),
    padding in the middle, ids past the end, and row 0."""
    def padded(n_rows, hp, k):
        ids = np.full(hp, -1, np.int32)
        ids[:k] = r.choice(n_rows, size=k, replace=False)
        return ids
    return [
        (64, 128, padded(64, 16, 11)),
        (256, 256, padded(256, 32, 32)),
        (32, 512, np.array([3, -1, 0, 31, 32, 99, -1, 7], np.int32)),
        (48, 6, np.array([-1, 2, 47, 5, -1, 0, 2], np.int32)),  # 24-byte rows
    ]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_consolidate_region_matches_reference(jx, dtype):
    """Bit for bit against Pallas (interpret) and xla; -1 slots are zero
    rows, ids past the end clamp to the last row."""
    r = np.random.default_rng(1)
    for n_rows, elems, ids in region_cases(r):
        src = payload(r, (n_rows, elems), dtype)
        got = cons.consolidate_region(t(src), t(ids))
        for backend in JAX_BACKENDS:
            want = jx.cons.consolidate_region(j(src), j(ids), kernel_backend=backend)
            assert_bits(got, want, (backend, n_rows, ids))
        assert not got[torch.from_numpy(ids < 0)].any()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_scatter_region_matches_reference(jx, dtype):
    """Bit for bit against Pallas (interpret) and xla with -1 padding and a
    real write to row 0 (tests/test_kernels.py's row-0 case). Ids past the
    end are dropped, which is the xla reference's and the oracle's rule; the
    Pallas path clamps such a write onto the last row, so those cases hold
    to xla and the oracle only."""
    r = np.random.default_rng(2)
    cases = [(n, e, ids, bool((ids < n).all())) for n, e, ids in region_cases(r)]
    cases.append((16, 128, np.array([3, 0, -1, -1, 5, -1, -1, -1], np.int32), True))
    for n_rows, elems, ids, in_range in cases:
        dst = payload(r, (n_rows, elems), dtype)
        region = payload(r, (ids.shape[0], elems), dtype)
        dst_t = t(dst)
        got = cons.scatter_region(dst_t, t(region), t(ids))
        assert got is dst_t  # written in place
        for backend in JAX_BACKENDS if in_range else ("xla",):
            want = jx.cons.scatter_region(j(dst), j(region), j(ids), kernel_backend=backend)
            assert_bits(got, want, (backend, n_rows, ids))
        oracle = registry.get_kernel("scatter_region").oracle
        assert_bits(got, oracle(j(dst), j(region), ids), ids)


def test_scatter_region_last_slot_wins():
    """Duplicate destinations: the last slot's row lands, as in the numpy
    oracle (the Pallas grid's order); the plain version decides the winner
    itself, so it is the same on any device."""
    r = np.random.default_rng(4)
    dst = r.standard_normal((20, 8)).astype(np.float32)
    region = r.standard_normal((9, 8)).astype(np.float32)
    ids = np.array([4, 0, 4, -1, 19, 0, 4, 25, 19], np.int32)
    want = registry.get_kernel("scatter_region").oracle(dst, region, ids)
    got = cons.scatter_region(t(dst), t(region), t(ids))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[4], region[6]) and np.array_equal(want[0], region[5])


# --------------------------------------------------------------------------
# K7: GQA attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,KVH,S,Sk,hd,causal,dtype", [
    (2, 2, 2, 40, 40, 16, True, np.float32),        # G = 1
    (1, 4, 2, 200, 200, 64, True, "bfloat16"),      # G = 2, S not a multiple of 128
    (2, 14, 2, 130, 130, 64, True, np.float32),     # G = 7 (qwen2-0.5b's heads)
    (1, 14, 2, 33, 77, 32, False, "bfloat16"),      # not causal, Sk != S
])
def test_gqa_attention_matches_reference(jx, B, H, KVH, S, Sk, hd, causal, dtype):
    r = np.random.default_rng(6)
    q = payload(r, (B, H, S, hd), dtype)
    k = payload(r, (B, KVH, Sk, hd), dtype)
    v = payload(r, (B, KVH, Sk, hd), dtype)
    got = fa.gqa_attention(t(q), t(k), t(v), causal=causal)
    want = jx.fa.gqa_attention(j(q), j(k), j(v), causal=causal, kernel_backend="xla")
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    tol = FA_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_gqa_attention_matches_naive_softmax_and_chunks(monkeypatch):
    """The plain version against a float64 numpy softmax, causal and not,
    with query chunks of one position (the chunking the full-width shapes
    take) and of all of them."""
    r = np.random.default_rng(8)
    B, H, KVH, S, hd = 2, 6, 2, 37, 16
    q = r.standard_normal((B, H, S, hd)).astype(np.float32)
    k = r.standard_normal((B, KVH, S, hd)).astype(np.float32)
    v = r.standard_normal((B, KVH, S, hd)).astype(np.float32)
    kk, vv = (np.repeat(a.astype(np.float64), H // KVH, axis=1) for a in (k, v))
    for causal in (True, False):
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
        if causal:
            s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        naive = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vv)
        whole = fa.gqa_attention(t(q), t(k), t(v), causal=causal)
        np.testing.assert_allclose(whole.numpy(), naive, rtol=1e-5, atol=1e-5)
        monkeypatch.setattr(fa, "CHUNK_SCORES", 1)
        chunked = fa.gqa_attention(t(q), t(k), t(v), causal=causal)
        monkeypatch.undo()
        np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    empty = fa.gqa_attention(t(q), t(k[:, :, :0]), t(v[:, :, :0]), causal=False)
    assert empty.shape == q.shape and not empty.any()  # Sk = 0: zeros, not NaN


# --------------------------------------------------------------------------
# tiered_lookup
# --------------------------------------------------------------------------
def test_tiered_lookup_matches_reference(jx):
    """rows[fused[ids]] bit for bit against Pallas (interpret) and xla, with
    -1 and out-of-range ids (zero rows) and 2-D ids."""
    r = np.random.default_rng(10)
    rows = r.standard_normal((96, 12)).astype(np.float32)
    fused = r.permutation(96)[:70].astype(np.int32)
    ids = np.concatenate([r.integers(0, 70, 30), [-1, -5, 69, 70, 500, 0]]).astype(np.int32)
    ids = ids.reshape(4, 9)
    got = tl.tiered_lookup(t(rows), t(fused), t(ids))
    for backend in JAX_BACKENDS:
        want = jx.tl.tiered_lookup(j(rows), j(fused), j(ids), kernel_backend=backend)
        assert_bits(got, want, backend)
    oracle = registry.get_kernel("tiered_lookup").oracle
    assert_bits(got, oracle(rows, fused, ids))


# --------------------------------------------------------------------------
# the registry itself
# --------------------------------------------------------------------------
def test_registry_matches_reference_names_and_fields(jx):
    assert registry.kernel_names() == jx.reg.kernel_names()
    assert len(registry.all_kernels()) == 9
    for spec in registry.all_kernels():
        jspec = jx.reg.get_kernel(spec.name)
        assert spec.example is not None, spec.name
        assert (spec.oracle is None) == (jspec.oracle is None), spec.name


def jitted_ref(ref, args, kw):
    """The reference entry's ``ref`` under ``jax.jit``, its array arguments
    traced and the rest bound: one compile where eager compiles each op
    (the exact entries stay bit for bit: integer ops and bit copies)."""
    import jax

    at = [i for i, a in enumerate(args) if hasattr(a, "shape")]

    def call(*arrays):
        full = list(args)
        for i, a in zip(at, arrays):
            full[i] = a
        return ref(*full, **kw)

    return jax.jit(call)(*[args[i] for i in at])


def test_registry_examples_match_reference(jx):
    """Each entry's example holds the JAX entry's numbers; the port's plain
    version on it equals the JAX reference (exact entries bit for bit, the
    attention entries within 1e-5) and the port's oracle agrees. The
    paged-attention example gives every sequence the reference's one global
    pool as its own, so the two layouts select the same pages."""
    for spec in registry.all_kernels():
        args, kw = spec.example("cpu")
        jargs, jkw = jx.reg.get_kernel(spec.name).example()
        assert kw == jkw, spec.name
        paged = spec.name == "paged_attention"
        for a, b in zip(args, jargs):
            if isinstance(a, torch.Tensor):
                a = a[0] if paged and a.dim() == 5 else a  # one sequence's pool
                assert np.array_equal(a.numpy(), np.asarray(b)), spec.name
            else:
                assert a == b, spec.name
        plain_args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        got = spec.plain(*plain_args, **kw)
        want = jitted_ref(jx.reg.get_kernel(spec.name).ref, jargs, jkw)
        got = got if isinstance(got, tuple) else (got,)
        want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(got, want):
            if spec.name in ("gqa_attention", "paged_attention"):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
            else:
                assert_bits(g, w, spec.name)
        if spec.oracle is not None:
            o = spec.oracle(*[a.numpy() if isinstance(a, torch.Tensor) else a for a in args])
            o = o if isinstance(o, tuple) else (o,)
            for g, w in zip(got, o):
                assert_bits(g, w, spec.name)


def test_registry_walk_on_cpu_tensors_launches_nothing():
    """Every wrapper on CPU tensors runs its plain version and counts no
    launch; the entry points' "torch" backend does the same."""
    before = registry.launch_counts()
    for spec in registry.all_kernels():
        args, kw = spec.example("cpu")
        copy = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        got = registry.dispatch(spec.name, "auto", *args, **kw)
        want = registry.dispatch(spec.name, "torch", *copy, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), spec.name
    assert registry.launch_counts() == before


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card_cases(dev):
    """(name, args, kwargs) edge cases of K5a, K5b and K7 on the card."""
    g = torch.Generator(device="cpu").manual_seed(3)
    rnd = lambda *shape, dtype=torch.float32: torch.randn(  # noqa: E731
        shape, generator=g).to(dtype).to(dev)
    ids = lambda *vals: torch.tensor(vals, dtype=torch.int32, device=dev)  # noqa: E731
    cases = [
        ("consolidate_region", (rnd(50, 1024), ids(*[-1] * 8)), {}),  # all padded
        ("consolidate_region", (rnd(50, 6, dtype=torch.bfloat16),  # 12-byte rows
                                ids(0, -1, 49, 50, 7)), {}),
        ("scatter_region", (rnd(50, 1024), rnd(8, 1024), ids(*[-1] * 8)), {}),
        ("scatter_region", (rnd(50, 1024), rnd(300, 1024), ids(*[17] * 300)), {}),  # one dest
        ("scatter_region", (rnd(50, 3, dtype=torch.bfloat16), rnd(6, 3, dtype=torch.bfloat16),
                            ids(0, 49, -1, 50, 0, 3)), {}),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KVH, S, Sk, hd, causal in [
                (1, 2, 1, 50, 50, 16, True),      # hd 16
                (1, 4, 2, 70, 70, 256, True),     # hd 256 (over 48 KB of shared memory)
                (1, 16, 1, 40, 40, 64, True),     # G 16
                (2, 14, 2, 1, 1, 64, True),       # S 1
                (40, 28, 4, 9, 9, 128, True),     # B * KVH = 160 > 132 SMs
                (1, 4, 2, 5, 0, 64, False),       # Sk 0
                (2, 6, 3, 33, 100, 40, False),    # Sk != S, hd 40
                (1, 130, 2, 9, 9, 8, True)]:      # G 65 (two head chunks), hd 8
            cases.append(("gqa_attention", (rnd(B, H, S, hd, dtype=dtype),
                                             rnd(B, KVH, Sk, hd, dtype=dtype),
                                             rnd(B, KVH, Sk, hd, dtype=dtype)),
                          dict(causal=causal)))
    # bf16 scores scaled by 8 (std 8 instead of 1): sharp rows for the
    # softmax on the tensor-core fragments. q and k lie on grids of 2 and
    # 1/4, so every score is exact in float32 whatever the order of its sums:
    # at this scale one float32 rounding of a score (|q.k| near 200) moves a
    # probability by about 2e-6, past the 1e-6 that CARD_TOL allows near 0,
    # for any two float32 versions (with normal draws the plain version
    # itself falls outside CARD_TOL of a float64 softmax at some outputs:
    # repro_torch/kernels/flash_attention/accuracy.py)
    grid = lambda step, *shape: (torch.randn(shape, generator=g) * 4).round().mul(  # noqa: E731
        step).to(torch.bfloat16).to(dev)
    cases.append(("gqa_attention", (grid(2.0, 2, 14, 300, 64), grid(0.25, 2, 2, 300, 64),
                                     rnd(2, 2, 300, 64, dtype=torch.bfloat16)),
                  dict(causal=True)))
    return cases


# K7 against its plain version: float32 sums in another order. Float32
# outputs within 1e-5; bf16 outputs within one bf16 rounding step.
CARD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
            torch.bfloat16: dict(atol=1e-6, rtol=2 ** -7)}


@pytest.mark.cuda
def test_new_kernels_match_plain_versions_on_the_card():
    """On a CUDA card K5a and K5b equal their plain versions bit for bit and
    K7 is within CARD_TOL; every wrapper launches its kernel once a case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    dev = torch.device("cuda")
    cases = _card_cases(dev)
    registry.reset_launch_counts()
    for name, args, kw in cases:
        spec = registry.get_kernel(name)
        copy = [a.clone() for a in args]
        got, want = spec.kernel(*args, **kw), spec.plain(*copy, **kw)
        torch.cuda.synchronize()
        shapes = [tuple(a.shape) for a in args]
        assert got.dtype == want.dtype and got.shape == want.shape, (name, shapes)
        if name == "gqa_attention":
            assert torch.isfinite(got).all(), shapes
            torch.testing.assert_close(got.float(), want.float(), **CARD_TOL[got.dtype],
                                       msg=lambda m: f"{shapes} {got.dtype} {kw}: {m}")
        else:
            assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bfloat16
                               else got, want.view(torch.uint8)
                               if want.dtype == torch.bfloat16 else want), (name, shapes)
    counts = registry.launch_counts()
    for name in ("consolidate_region", "scatter_region", "gqa_attention"):
        assert counts[name] == sum(c == name for c, _, _ in cases), name
