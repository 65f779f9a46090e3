"""The port's kernels on the CPU: each plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and its ``xla`` reference, bit for
bit with dtypes, on the same numpy inputs; and the port's kernel registry.

The CUDA kernels themselves run only on the card: the ``cuda``-marked test
holds each to its plain version there (bit for bit, and the paged-attention
kernel within float tolerance) (``python -m pytest -m cuda
tests/test_torch_kernels.py`` on a machine with the card, which needs no
JAX), and ``chip_smoke.py`` does the same at full width. Here a CPU tensor
must take the plain version and leave the launch counts alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import registry  # noqa: E402

JAX_BACKENDS = ("pallas", "xla")


def _port(name, *args):
    """The port's kernel through its wrapper on CPU tensors (plain path)."""
    targs = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a
             for a in args]
    before = registry.launch_counts()
    out = registry.dispatch(name, "auto", *targs)
    assert registry.launch_counts() == before  # a CPU tensor launches nothing
    out = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in out]


def _jax(name, backend, *args):
    import jax.numpy as jnp
    from repro.kernels import registry as jreg

    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    out = jreg.dispatch(name, backend, *jargs)
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o) for o in out]


def _assert_same(name, *args):
    got = _port(name, *args)
    for backend in JAX_BACKENDS:
        want = _jax(name, backend, *args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (backend, g.dtype, w.dtype)
            assert np.array_equal(g.reshape(-1).view(np.uint8),
                                  w.reshape(-1).view(np.uint8)), backend


def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("k,n_bins,lo", [(300, 40, 0), (1000, 257, -300)])
def test_bincount(k, n_bins, lo):
    """Negative ids wrap once; ids still out of range drop."""
    r = rng()
    ids = r.integers(lo, n_bins + 9, size=k).astype(np.int32)
    w = r.integers(-3, 9, size=k).astype(np.int32)
    _assert_same("bincount", ids, w, n_bins)


@pytest.mark.parametrize("n_hp,hp_ratio,dtype", [
    (13, 32, np.bool_), (5, 7, np.bool_), (11, 32, np.uint8)])
def test_hot_count(n_hp, hp_ratio, dtype):
    """n_hp is not a multiple of the Pallas block (8 huge pages)."""
    r = rng()
    if dtype is np.bool_:
        hot = r.random(n_hp * hp_ratio) < 0.3
    else:
        hot = r.integers(0, 2, n_hp * hp_ratio).astype(np.uint8)
    if dtype is np.uint8:
        # the Pallas kernel takes bool/int32: hold the uint8 path to xla only
        got = _port("hot_count", hot, hp_ratio)[0]
        want = _jax("hot_count", "xla", hot, hp_ratio)[0]
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return
    _assert_same("hot_count", hot, hp_ratio)


@pytest.mark.parametrize("rows,width,k,hi", [
    (1, 256, 32, 3),      # mass ties among few values
    (4, 200, 200, 2),     # k == width
    (3, 130, 17, 1000),   # several rows, few ties
    (2, 96, 40, 0),       # every entry tied (-1 or 0)
])
def test_topk_rows(rows, width, k, hi):
    r = rng()
    mat = r.integers(-1, hi + 1, size=(rows, width)).astype(np.int32)
    _assert_same("topk_rows", mat, k)


@pytest.mark.parametrize("dtype,shape,ids_shape", [
    (np.float32, (64, 8), (3, 5)),   # 2-D ids
    (np.uint8, (40, 6), (2, 2, 5)),  # uint8 payload, 3-D ids
])
def test_gather_rows(dtype, shape, ids_shape):
    r = rng()
    rows = (r.integers(0, 255, size=shape).astype(dtype) if dtype is np.uint8
            else r.standard_normal(shape).astype(dtype))
    ids = r.integers(0, shape[0], size=ids_shape).astype(np.int32)
    _assert_same("gather_rows", rows, ids)


def test_gather_rows_out_of_range_ids_match_jnp_indexing():
    """Negative ids wrap once, then ids clamp, as jnp's rows[ids] does (the
    Pallas kernel requires in-range ids, so this holds to xla only)."""
    r = rng()
    rows = r.standard_normal((20, 4)).astype(np.float32)
    ids = np.array([-1, -20, -21, -500, 19, 20, 999, 0], np.int32)
    got = _port("gather_rows", rows, ids)[0]
    want = _jax("gather_rows", "xla", rows, ids)[0]
    assert np.array_equal(got, want)


def test_kernel_wrappers_reject_bad_inputs():
    from repro_torch.kernels.histogram.ops import bincount
    from repro_torch.kernels.topk.ops import topk_rows

    with pytest.raises(ValueError, match="int32"):
        bincount(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="k <= width"):
        topk_rows(torch.zeros((1, 4), dtype=torch.int32), 5)


def test_registry_names_duplicates_and_unknowns():
    assert registry.kernel_names() == (
        "bincount", "consolidate_region", "gather_rows", "gqa_attention", "hot_count",
        "paged_attention", "scatter_region", "tiered_lookup", "topk_rows")
    spec = registry.get_kernel("bincount")
    with pytest.raises(ValueError, match="already registered"):
        registry.register_kernel("bincount", spec.kernel, spec.plain)
    with pytest.raises(ValueError, match="have"):
        registry.dispatch("no_such_kernel", "auto")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        registry.dispatch("bincount", "xla")


def test_torch_backend_runs_the_plain_version():
    ids = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    w = torch.ones(4, dtype=torch.int32)
    before = registry.launch_counts()
    out = registry.dispatch("bincount", "torch", ids, w, 4)
    assert out.tolist() == [1, 2, 0, 1]
    assert registry.launch_counts() == before


def test_launch_counts_reset():
    registry.count_launch("hot_count")
    assert registry.launch_counts()["hot_count"] >= 1
    registry.reset_launch_counts()
    assert set(registry.launch_counts().values()) == {0}


def _mass_ties(r, width, n_hot):
    """One filter-like row: -1 everywhere but n_hot scores in [0, 50)."""
    row = np.full((1, width), -1, np.int32)
    row[0, r.choice(width, n_hot, replace=False)] = r.integers(0, 50, n_hot)
    return row


def _extremes(r, shape):
    """Random int32 keys, a third of them the extremes and their neighbours."""
    mat = r.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    edge = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)
    pick = r.random(shape) < 1 / 3
    mat[pick] = r.choice(edge, int(pick.sum()))
    return mat


def _runs_of_512(r, n_hp=3000, n_bins=8000):
    """gpt // 512 over an identity layout: runs of 512 equal ids, weights
    mostly 0, the last run unmapped (-1, which wraps to the last bin)."""
    ids = np.repeat(np.arange(n_hp, dtype=np.int32), 512)
    ids[-512:] = -1
    w = (r.integers(1, 4, ids.size) * (r.random(ids.size) < 0.3)).astype(np.int32)
    return ids, w, n_bins


def _zipf_ids(r, k, n):
    """Zipf (a = 1.3) page ids into n pages plus the extra bin n that takes
    the invalid ids (5% of them), unit weights."""
    ids = np.minimum(r.zipf(1.3, k) - 1, n).astype(np.int32)
    ids[r.random(k) < 0.05] = n
    return ids, np.ones(k, np.int32), n + 1


def _card_cases(r):
    """(kernel, args) edge cases for the card: every code path of each
    kernel (shared/global histogram, vector/byte loads, ties, ragged tiles)."""
    ints = lambda lo, hi, shape: r.integers(lo, hi, shape).astype(np.int32)  # noqa: E731
    return [
        ("bincount", (ints(-300, 300, 5000), ints(-2, 4, 5000), 257)),  # wrap + drop
        ("bincount", (ints(-9, 20_000, 70_000), ints(0, 3, 70_000), 20_000)),  # global
        # every id in one bin (shared and global path, a k % 4 tail); runs
        # of 512 equal ids with mostly zero weights and a last run of -1, the
        # host histogram's layout; a Zipf draw into 40,001 bins whose last
        # bin takes the invalid ids, the access histogram's layout
        ("bincount", (np.full(100_003, 7, np.int32), ints(-5, 6, 100_003), 10)),
        ("bincount", (np.full(70_001, 19_999, np.int32), ints(0, 9, 70_001), 20_000)),
        ("bincount", _runs_of_512(r)),
        ("bincount", _zipf_ids(r, 300_001, 40_000)),
        ("hot_count", (r.random(64 * 512) < 0.2, 512)),
        ("hot_count", (r.random(37 * 7) < 0.5, 7)),  # byte path
        ("hot_count", (ints(0, 256, 33 * 48).astype(np.uint8), 48)),
        ("topk_rows", (ints(-1, 3, (3, 5000)), 600)),  # mass ties
        ("topk_rows", (ints(-1, 1, (2, 4096)), 4096)),  # k == width
        ("topk_rows", (np.full((2, 9000), 7, np.int32), 1000)),  # all tied
        ("topk_rows", (ints(-2**31 + 1, 2**31 - 1, (4, 12_345)), 2048)),
        ("topk_rows", (ints(0, 50, (1, 1)), 1)),
        # wide rows, spread over many CTAs: -1 mass ties whose wanted ties
        # end inside the first chunk; a multi-chunk row all tied; int32
        # extremes; just below and above the narrow-row threshold (2,048
        # keys); k == width on a multi-chunk row (scalar loads)
        ("topk_rows", (_mass_ties(r, 1_000_003, 600), 2048)),
        ("topk_rows", (np.full((1, 40_000), 5, np.int32), 4096)),
        ("topk_rows", (_extremes(r, (3, 200_001)), 1000)),
        ("topk_rows", (ints(-1, 2, (3, 2048)), 2000)),
        ("topk_rows", (ints(-1, 2, (3, 2049)), 2000)),
        ("topk_rows", (ints(-1, 3, (1, 3001)), 3001)),
        ("gather_rows", (r.standard_normal((300, 1024)).astype(np.float32),
                         ints(0, 300, (2, 64)))),
        ("gather_rows", (ints(0, 255, (40, 3)).astype(np.uint8),
                         np.array([-1, -40, -41, 0, 39, 40, 999], np.int32))),
    ]


def _paged_cases(r):
    """paged_attention edge cases for the card, in float32 and bf16: G = 7,
    a len of 0, lens off the page grid and past the table's capacity, table
    entries out of range on both sides, several chunks and splits, and
    G = 16 with hd = 256 (over 48 KB of shared memory)."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, KVH, G, hd, n_pool, page, pps in [(4, 2, 7, 64, 40, 16, 36),
                                                 (3, 1, 16, 256, 9, 8, 12),
                                                 (2, 4, 1, 128, 30, 32, 25)]:
            pages = lambda: torch.from_numpy(  # noqa: E731
                r.standard_normal((B, KVH, n_pool, page, hd)).astype(np.float32)).to(dtype)
            q = torch.from_numpy(r.standard_normal((B, KVH, G, hd)).astype(np.float32)).to(dtype)
            btab = r.integers(-3, n_pool + 3, (B, pps)).astype(np.int32)
            lens = r.integers(1, pps * page + 40, B).astype(np.int32)
            lens[0] = 0
            cases.append(("paged_attention", (q, pages(), pages(), btab, lens)))
    return cases


# paged_attention against its plain version: the same float32 sums in
# another order. Float32 outputs within 1e-5; bf16 outputs within one bf16
# rounding step (2^-7 relative), where the two float32 results straddle it.
PAGED_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=1e-6, rtol=2 ** -7)}


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On a CUDA card every wrapper launches its kernel, which must equal its
    plain version bit for bit (paged_attention: within PAGED_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    dev = torch.device("cuda")
    registry.reset_launch_counts()
    r = rng()
    cases = _card_cases(r) + _paged_cases(r)
    for name, args in cases:
        targs = [(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a).to(dev)
                 if hasattr(a, "shape") else a for a in args]
        spec = registry.get_kernel(name)
        got, want = spec.kernel(*targs), spec.plain(*targs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        shapes = [tuple(a.shape) for a in targs if hasattr(a, "shape")]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, shapes)
            if name == "paged_attention":
                assert torch.isfinite(g).all() and not g[0].any(), shapes  # len 0 -> 0
                torch.testing.assert_close(g.float(), w.float(), **PAGED_TOL[g.dtype],
                                           msg=lambda m: f"{shapes} {g.dtype}: {m}")
            else:
                assert torch.equal(g, w), (name, shapes)
    extra = _card_invariants(r, dev)
    counts = registry.launch_counts()
    assert counts == {n: sum(c == n for c, _ in cases) + extra.get(n, 0) for n in counts}


def _card_invariants(r, dev):
    """On the card: paged_attention at G = 7, hd = 64 with a len that leaves
    most splits empty, one at the table's full capacity, a repeated call
    (the tickets reset) and a consistent permutation of the physical pages
    with btab remapped to match, both bit-identical to the first call (the
    split plan never looks at btab); bincount on views that are not 16-byte
    aligned. Returns the launches it made, by kernel name."""
    from repro_torch.kernels.histogram import bincount, ops as hist_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    B, KVH, G, hd, n_pool, page, pps = 4, 2, 7, 64, 80, 16, 72
    lens = torch.tensor([40, pps * page, 700, 1], dtype=torch.int32, device=dev)
    btab = np.stack([r.permutation(n_pool)[:pps] for _ in range(B)]).astype(np.int32)
    perm = r.permutation(n_pool)  # page p of every pool moves to perm[p]
    btab2 = torch.from_numpy(perm[btab].astype(np.int32)).to(dev)
    btab = torch.from_numpy(btab).to(dev)
    inv = torch.from_numpy(np.argsort(perm)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        draw = lambda *shape: torch.from_numpy(  # noqa: E731
            r.standard_normal(shape).astype(np.float32)).to(dev, dtype)
        q, k, v = draw(B, KVH, G, hd), draw(B, KVH, n_pool, page, hd), draw(B, KVH, n_pool, page, hd)
        out = pa_ops.paged_attention(q, k, v, btab, lens)
        torch.testing.assert_close(out.float(), pa_ops.paged_attention_plain(
            q, k, v, btab, lens).float(), **PAGED_TOL[dtype])
        assert torch.equal(out, pa_ops.paged_attention(q, k, v, btab, lens)), dtype
        moved = pa_ops.paged_attention(q, k[:, :, inv].contiguous(), v[:, :, inv].contiguous(),
                                       btab2, lens)
        assert torch.equal(out, moved), dtype
    for n in (5_000, 20_000):  # the shared and the global path
        ids, w, n_bins = _zipf_ids(r, 50_003, n)
        ids, w = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
        for off in (1, 2, 3):
            got = bincount(ids[off:], w[off:], n_bins)
            assert torch.equal(got, hist_ops.bincount_plain(ids[off:], w[off:], n_bins)), off
    return {"paged_attention": 6, "bincount": 6}
