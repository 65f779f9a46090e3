"""The port's model layers, dense transformer and paged-attention kernel
against the JAX package, on the CPU (the kernels' plain PyTorch versions).

Both packages compute from the same numpy inputs and the same weights (the
JAX package's init, carried across with ``interop.params_from_numpy``) on
the reduced qwen2 in float32 with 8-token pages, the fixture of
``tests/test_serve_engine.py``. Tolerances: float32 sums taken in another
order than XLA's, and ``cos``/``sin`` that differ from XLA's in the last
bit, move values by about 1e-7 relative; the tests allow 1e-5 on one layer
and 1e-4 on the whole model. Where nothing is computed (pages not written,
the block table, the lengths, the layout) the tests require bit equality.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels.paged_attention import ops as jpa  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.kernels import registry as kregistry  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry, transformer as T  # noqa: E402

ATOL_LAYER, ATOL_MODEL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, port cfg, JAX params, port params): the serve tests' model."""
    jcfg = jconfigs.reduced("qwen2-0.5b").replace(dtype=jnp.float32, page_size=8)
    cfg = configs.reduced("qwen2-0.5b").replace(dtype=torch.float32, page_size=8)
    jparams = jregistry.build(jcfg).init(jax.random.PRNGKey(7))
    params = interop.params_from_numpy(np_tree(jparams), device="cpu")
    return jcfg, cfg, jparams, params


def jitted(fn, cfg, *args):
    """A reference layer call under ``jax.jit`` (``cfg`` static): one
    compile where the eager call compiles each primitive; within the
    layer tolerance of the eager result."""
    return jax.jit(fn, static_argnums=0)(cfg, *args)


def close(got, want, atol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=what)


# --------------------------------------------------------------------------
# configs and the model registry
# --------------------------------------------------------------------------
def test_configs_mirror_the_reference():
    for get in ("get", "reduced"):
        j, p = getattr(jconfigs, get)("qwen2-0.5b"), getattr(configs, get)("qwen2-0.5b")
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
        pf = {f.name: getattr(p, f.name) for f in dataclasses.fields(p) if f.name != "dtype"}
        assert jf == pf
        assert p.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert (p.hd, p.n_groups, p.attn_layers) == (j.hd, j.n_groups, j.attn_layers)
        assert p.param_count() == j.param_count()
    assert configs.get("qwen2_0_5b").replace(page_size=16).page_size == 16
    for arch in configs.all_archs():  # every arch id builds (tests/test_torch_families.py)
        assert registry.build(arch).cfg == configs.get(arch)
    with pytest.raises(KeyError):
        configs.reduced("no-such-arch")


def test_init_params_layout_matches_reference():
    """The port's own random init has the reference's tree, shapes and
    dtypes (stacked ``groups/layer0`` with a leading n_groups axis)."""
    jcfg = jconfigs.reduced("qwen2-0.5b")
    model = registry.build(configs.reduced("qwen2-0.5b"))
    got = model.init(seed=3, device="cpu")
    want = jax.eval_shape(lambda: jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
    flat_got = {"/".join(map(str, k)): v for k, v in _flatten(got)}
    flat_want = {"/".join(str(getattr(p, "key", p)) for p in k): v
                 for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat_got) == set(flat_want)
    for k, v in flat_got.items():
        assert tuple(v.shape) == flat_want[k].shape and v.dtype == torch.bfloat16, k
    again = model.init(seed=3, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flatten(got), _flatten(again)))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_unported_families_raise():
    """Once the unported paths raised here; every family is ported now.
    The unrolled attention's configs (the dry run's: ``unroll``,
    ``causal_skip``, jamba with ``unroll``) build, init params and a cache,
    and run ``forward_train`` to finite hidden states of the batch's shape.
    What still raises: the training meshes (``launch.train --mesh
    single|multi``) in a job of one rank refuse the production mesh's 256
    or 512 ranks, naming both counts."""
    from repro_torch.launch import train as launch_train

    cfg = configs.reduced("qwen2-0.5b")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    for flags in (cfg.replace(unroll=True), cfg.replace(causal_skip=True),
                  configs.reduced("jamba-1.5-large-398b").replace(unroll=True)):
        cache = T.init_cache(flags, 1, 16, device="cpu")
        assert cache["lens"].shape == (1,)
        params = registry.build(flags).init(seed=0, device="cpu")
        h, aux = T.forward_train(flags, params, batch)
        assert h.shape == (1, 4, flags.d_model) and torch.isfinite(h).all()
        assert torch.isfinite(aux)
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks; this job has 1 "):
            launch_train.main(["--reduced", "--device", "cpu", "--mesh", mesh])


# --------------------------------------------------------------------------
# K6: the plain version against the reference, the wrapper on CPU tensors
# --------------------------------------------------------------------------
def _paged_inputs(r, B, KVH, G, hd, n_pool, page, pps):
    q = r.standard_normal((B, KVH, G, hd)).astype(np.float32)
    kp = r.standard_normal((B, KVH, n_pool, page, hd)).astype(np.float32)
    vp = r.standard_normal((B, KVH, n_pool, page, hd)).astype(np.float32)
    btab = np.stack([r.permutation(n_pool)[:pps] for _ in range(B)]).astype(np.int32)
    lens = r.integers(1, pps * page, size=B).astype(np.int32)
    lens[0] = 0  # an empty sequence gives zeros
    return q, kp, vp, btab, lens


@pytest.mark.parametrize("B,KVH,G,hd,n_pool,page,pps", [
    (3, 2, 7, 16, 12, 8, 9),   # G = 7, lens not multiples of the page
    (2, 1, 2, 64, 6, 16, 6),   # every page of the pool in the table
])
def test_paged_attention_plain_matches_reference(B, KVH, G, hd, n_pool, page, pps):
    """The reference's kernel entry (``kernel_backend="xla"``, its ref.py)
    on a global pool: sequence b's page p is global page b * n_pool + p."""
    q, kp, vp, btab, lens = _paged_inputs(np.random.default_rng(5), B, KVH, G, hd,
                                          n_pool, page, pps)
    glob = lambda x: x.transpose(1, 0, 2, 3, 4).reshape(KVH, B * n_pool, page, hd)  # noqa: E731
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(glob(kp)), jnp.asarray(glob(vp)),
        jnp.asarray(btab + (np.arange(B) * n_pool)[:, None]), jnp.asarray(lens),
        kernel_backend="xla"))
    args = [t(a) for a in (q, kp, vp, btab, lens)]
    before = kregistry.launch_counts()
    got = kregistry.dispatch("paged_attention", "auto", *args)  # the wrapper, CPU tensors
    assert kregistry.launch_counts() == before
    assert torch.equal(got, pa.paged_attention_plain(*args))
    close(got.numpy(), want, ATOL_LAYER)
    assert not got[0].any() and torch.isfinite(got).all()


def test_paged_attention_clamps_the_block_table():
    """Out-of-range table entries read the clamped page, as the reference's
    ``_clamp`` makes them; bad inputs raise."""
    q, kp, vp, btab, lens = _paged_inputs(np.random.default_rng(6), 2, 2, 7, 16, 5, 8, 7)
    bad = btab.copy()
    bad[0, :2], bad[1, 3] = -4, 99
    args = [t(a) for a in (q, kp, vp, bad, lens)]
    clamped = [t(a) for a in (q, kp, vp, np.clip(bad, 0, 4), lens)]
    assert torch.equal(pa.paged_attention(*args), pa.paged_attention_plain(*clamped))
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError, match="share a dtype"):
        pa.paged_attention(args[0].double(), *args[1:])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_layers_match_reference(setup):
    jcfg, cfg, jparams, params = setup
    r = np.random.default_rng(8)
    x = r.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    pos = r.integers(0, 200, size=(3, 5)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[0], jparams["groups"])["layer0"]
    pl = T._group(params["groups"], 0)["layer0"]
    close(L.apply_norm(cfg, pl["norm1"], t(x)).numpy(),
          jitted(JL.apply_norm, jcfg, jl["norm1"], jnp.asarray(x)), ATOL_LAYER, "norm")
    for got, want in zip(L.qkv(cfg, pl["attn"], t(x), t(pos)),
                         jitted(JL.qkv, jcfg, jl["attn"], jnp.asarray(x), jnp.asarray(pos))):
        close(got.numpy(), want, ATOL_LAYER, "qkv")
    close(L.apply_mlp(cfg, pl["ffn"], t(x)).numpy(),
          jitted(JL.apply_mlp, jcfg, jl["ffn"], jnp.asarray(x)), ATOL_LAYER, "mlp")
    toks = r.integers(0, cfg.vocab, size=(3, 4)).astype(np.int32)
    close(L.embed(cfg, params["embed"], t(toks)).numpy(),
          JL.embed(jcfg, jparams["embed"], jnp.asarray(toks)), 0.0, "embed")
    close(L.unembed(cfg, params["embed"], t(x)).numpy(),
          jitted(JL.unembed, jcfg, jparams["embed"], jnp.asarray(x)), ATOL_LAYER, "unembed")


def test_unembed_of_bf16_params_gives_unrounded_float32_logits():
    """bf16 h and table: float32 logits equal to the float32 product of the
    upcast operands, as the reference's ``preferred_element_type=f32``."""
    jcfg = jconfigs.reduced("qwen2-0.5b")
    cfg = configs.reduced("qwen2-0.5b")
    r = np.random.default_rng(9)
    tok = jnp.asarray(r.standard_normal((cfg.vocab, cfg.d_model)), jnp.bfloat16)
    h = jnp.asarray(r.standard_normal((2, 3, cfg.d_model)), jnp.bfloat16)
    want = np.asarray(JL.unembed(jcfg, {"tok": tok}, h))
    got = L.unembed(cfg, interop.params_from_numpy({"tok": np.asarray(tok)}, "cpu"),
                    interop.params_from_numpy({"h": np.asarray(h)}, "cpu")["h"])
    assert got.dtype == torch.float32
    close(got.numpy(), want, ATOL_LAYER, "bf16 unembed")


def test_chunked_gqa_attention_matches_reference():
    r = np.random.default_rng(10)
    q = r.standard_normal((2, 21, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 21, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 21, 2, 16)).astype(np.float32)
    for causal in (True, False):
        got = L.chunked_gqa_attention(t(q), t(k), t(v), causal=causal, q_chunk=8)
        want = jax.jit(JL.chunked_gqa_attention, static_argnames=("causal", "q_chunk"))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, q_chunk=8)
        close(got.numpy(), want, ATOL_LAYER, f"causal={causal}")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny"])  # rotated; not (enc-dec)
def test_attention_decode_dense_matches_reference(arch):
    """One decode step against a dense cache: output and both caches within
    1e-5. A sequence with no slot left (lens = S_max) drops its write, as
    the reference's scatter does, and attends over the whole cache."""
    cfg = configs.reduced(arch).replace(dtype=torch.float32)
    jcfg = jconfigs.reduced(arch).replace(dtype=jnp.float32)
    p = L.init_attention(cfg, torch.Generator().manual_seed(4))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    r = np.random.default_rng(12)
    B, S_max = 4, 9
    x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (r.standard_normal((B, S_max, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
              for _ in range(2))
    lens = np.array([0, 4, S_max - 1, S_max], np.int32)
    want = jitted(JL.attention_decode_dense, jcfg, jp, jnp.asarray(x), jnp.asarray(kc),
                  jnp.asarray(vc), jnp.asarray(lens))
    got = L.attention_decode_dense(cfg, p, t(x), t(kc), t(vc), t(lens))
    for g, w, what in zip(got, want, ("out", "k_cache", "v_cache")):
        close(g.numpy(), w, ATOL_LAYER, f"{arch} {what}")
    assert np.array_equal(got[1][3].numpy(), kc[3]) and np.array_equal(got[2][3].numpy(), vc[3])


def test_attention_decode_paged_matches_reference(setup):
    """Output within 1e-5; the new token's K/V land in the same (sequence,
    page, offset) rows as the reference's, within 1e-5 (rotated by cos/sin),
    and every other row stays bit for bit as it was."""
    jcfg, cfg, jparams, params = setup
    r = np.random.default_rng(11)
    B, KVH, hd, page, n_pool, pps = 3, cfg.n_kv_heads, cfg.hd, cfg.page_size, 10, 8
    x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kp = r.standard_normal((B, KVH, n_pool, page, hd)).astype(np.float32)
    vp = r.standard_normal((B, KVH, n_pool, page, hd)).astype(np.float32)
    btab = np.stack([r.permutation(n_pool)[:pps] for _ in range(B)]).astype(np.int32)
    lens = np.array([0, 13, 40], np.int32)
    jl = jax.tree.map(lambda a: a[0], jparams["groups"])["layer0"]["attn"]
    wo, wk, wv = jitted(JL.attention_decode_paged,
                        jcfg, jl, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(btab), jnp.asarray(lens))
    pl = T._group(params["groups"], 0)["layer0"]["attn"]
    gk, gv = t(kp), t(vp)
    go, gk2, gv2 = L.attention_decode_paged(cfg, pl, t(x), gk, gv, t(btab), t(lens))
    assert gk2 is gk and gv2 is gv  # written in place
    close(go.numpy(), wo, ATOL_LAYER, "output")
    for got, want, before in ((gk.numpy(), np.asarray(wk), kp), (gv.numpy(), np.asarray(wv), vp)):
        touched = (want != before).any(axis=-1)
        assert np.array_equal(touched, (got != before).any(axis=-1))
        assert touched.sum() == B * KVH
        assert np.array_equal(got[~touched], want[~touched])
        close(got[touched], want[touched], ATOL_LAYER, "new rows")


# --------------------------------------------------------------------------
# the whole model: prefill, then three decode steps
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_runs(setup):
    """Prefill two 13-token sequences into 4 pages of 8, then three decode
    steps, in each package from the same weights and tokens."""
    jcfg, cfg, jparams, params = setup
    r = np.random.default_rng(12)
    toks = r.integers(0, cfg.vocab, size=(2, 13)).astype(np.int32)
    steps = r.integers(0, cfg.vocab, size=(3, 2, 1)).astype(np.int32)
    jm, m = jregistry.build(jcfg), registry.build(cfg)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_seq=20)
    log, cache = m.prefill(params, {"tokens": t(toks)}, max_seq=20)
    out = {"prefill": ((log.numpy(), interop.cache_to_numpy(cache)),
                       (np.asarray(jlog), np_tree(jcache)))}
    jdec = jax.jit(jm.decode)
    for i, s in enumerate(steps):
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(s))
        log, cache = m.decode(params, cache, t(s))
        out[f"decode{i}"] = ((log.numpy(), interop.cache_to_numpy(cache)),
                             (np.asarray(jlog), np_tree(jcache)))
    return out


@pytest.mark.parametrize("stage", ["prefill", "decode0", "decode1", "decode2"])
def test_model_matches_reference(model_runs, stage):
    (log, cache), (jlog, jcache) = model_runs[stage]
    close(log, jlog, ATOL_MODEL, "logits")
    assert np.array_equal(cache["btab"], jcache["btab"])
    assert np.array_equal(cache["lens"], jcache["lens"]) and cache["lens"].dtype == np.int32
    for key in ("k_pages", "v_pages"):
        got, want = cache["layers"]["layer0"][key], jcache["layers"]["layer0"][key]
        close(got, want, ATOL_MODEL, key)
        assert np.array_equal(got == 0, want == 0)  # the same rows are still empty


def test_cache_interop_round_trip():
    import ml_dtypes

    r = np.random.default_rng(13)
    tree = {"layers": {"layer0": {"k_pages": r.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)}},
            "lens": np.array([3, 4], np.int32)}
    cache = interop.cache_from_numpy(tree, device="cpu")
    assert cache["layers"]["layer0"]["k_pages"].dtype == torch.bfloat16
    back = interop.cache_to_numpy(cache)
    assert np.array_equal(back["layers"]["layer0"]["k_pages"],
                          tree["layers"]["layer0"]["k_pages"].astype(np.float32))
    cache["lens"] += 1  # the port's cache is written in place; the copy is not
    assert back["lens"].tolist() == [3, 4]
