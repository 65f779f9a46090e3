"""The port's training loss and its gradients against the JAX package, on
the CPU: ``transformer.loss_fn`` differentiated by autograd against
``jax.value_and_grad`` of the reference ``loss_fn`` (jitted, which changes
no result), from the same weights (the port's init carried to both
packages as numpy by ``interop``) and the same seeded batch.

Every layer kind that ``forward_train`` reaches is in a case: attention
with RoPE (qwen2, tied embeddings, qkv bias), M-RoPE positions (qwen2-vl),
Mamba with MoE (jamba, one super-block of attention + Mamba), mLSTM and
sLSTM (xlstm), MoE with its auxiliary loss and shared experts (qwen2-moe),
Whisper's encoder with cross-attention, LayerNorm and learned positions,
GeGLU (gemma); each reduced, in float32, remat "block" as the configs
default. Tolerances: the loss within LOSS_RTOL; each gradient leaf within
GRAD_RTOL of its largest entry (float32 sums in another order than XLA's,
and XLA's ``cos`` / ``exp``, move values by about 1e-6 of the leaf's
scale). The reference's own bf16 ``reduced()`` config: the loss within
BF16_LOSS_RTOL, each gradient leaf within BF16_GRAD_RTOL of its scale
(every projection and cotangent rounds to bf16, 2^-8 relative, in another
order; here about 5e-5 and 2e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-3, 5e-2
B, S = 2, 24
# case -> (arch, what both packages replace in its reduced() config)
CASES = {
    "qwen2-0.5b": ("qwen2-0.5b", {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "jamba": ("jamba-1.5-large-398b", dict(n_layers=2, attn_period=2)),  # attn, Mamba + MoE
    "xlstm-1.3b": ("xlstm-1.3b", {}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "whisper-tiny": ("whisper-tiny", {}),
    "gemma-7b": ("gemma-7b", {}),
}


def cfgs(arch: str, dtype32: bool = True, **rep):
    cfg, jcfg = configs.reduced(arch).replace(**rep), jconfigs.reduced(arch).replace(**rep)
    if dtype32:
        cfg, jcfg = cfg.replace(dtype=torch.float32), jcfg.replace(dtype=jnp.float32)
    return cfg, jcfg


def make_batch(cfg, seed: int) -> dict:
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": r.integers(-1, cfg.vocab, (B, S)).astype(np.int32)}  # -1: masked
    if cfg.mrope:
        batch["positions"] = r.integers(0, 40, (3, B, S)).astype(np.int32)
    if cfg.encdec:
        batch["frames"] = r.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(
            np.float32 if cfg.dtype == torch.float32 else jnp.bfloat16)
    return batch


def port_grads(cfg, tree: dict, batch: dict) -> tuple:
    """(loss, metrics, {path: grad}) of the port's loss_fn by autograd."""
    params = tr.map(lambda a: a.requires_grad_(), interop.params_from_numpy(tree, device="cpu"))
    loss, mets = registry.build(cfg).loss_fn(params, interop.params_from_numpy(batch, "cpu"))
    paths, leaves = zip(*tr.items(params))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: float(v.detach()) for k, v in mets.items()}, dict(zip(paths, grads))


def jax_grads(jcfg, tree: dict, batch: dict) -> tuple:
    jm = jregistry.build(jcfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b), has_aux=True))
    (loss, mets), grads = fn(jax.tree.map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {"/".join(str(p.key) for p in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), {k: float(v) for k, v in mets.items()}, flat


@pytest.fixture(scope="module")
def runs():
    """case -> (port (loss, metrics, grads), JAX (loss, metrics, grads))."""
    out = {}
    for i, (case, (arch, rep)) in enumerate(CASES.items()):
        cfg, jcfg = cfgs(arch, **rep)
        tree = interop.cache_to_numpy(registry.build(cfg).init(seed=20 + i, device="cpu"))
        batch = make_batch(cfg, 30 + i)
        out[case] = (port_grads(cfg, tree, batch), jax_grads(jcfg, tree, batch))
    return out


def close_leaf(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_reference(runs, case):
    """The loss, its ce / aux parts and every gradient leaf; the MoE cases'
    auxiliary loss is nonzero and reaches the router."""
    (loss, mets, grads), (jloss, jmets, jgrads) = runs[case]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(mets[k], jmets[k], rtol=LOSS_RTOL, atol=1e-7)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        close_leaf(g.numpy(), jgrads[k], f"{case} {k}")
    if CASES[case][0] in ("qwen2-moe-a2.7b", "jamba-1.5-large-398b"):
        assert mets["aux"] > 0
        assert any(np.abs(g.numpy()).max() > 0 for k, g in grads.items() if k.endswith("router"))


def test_bf16_loss_matches_reference():
    """The reference's own ``reduced()`` dtype (bf16 params and
    activations): the loss and ce within BF16_LOSS_RTOL, each gradient in
    the reference's dtype and within BF16_GRAD_RTOL of its leaf's scale."""
    cfg, jcfg = cfgs("qwen2-0.5b", dtype32=False)
    params = registry.build(cfg).init(seed=3, device="cpu")
    tree = interop.cache_to_numpy(params)  # bf16 leaves as float32 (exact)
    jtree = jax.tree.map(lambda a, p: jnp.asarray(a, jnp.bfloat16) if p.dtype == torch.bfloat16
                         else jnp.asarray(a), tree, params)
    batch = make_batch(cfg, 4)
    jm = jregistry.build(jcfg)
    (jloss, jmets), jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b), has_aux=True))(
        jtree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tr.map(lambda a: a.requires_grad_(), params)
    loss, mets = registry.build(cfg).loss_fn(params, interop.params_from_numpy(batch, "cpu"))
    grads = torch.autograd.grad(loss, tr.leaves(params))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(mets["ce"].item(), float(jmets["ce"]), rtol=BF16_LOSS_RTOL)
    for g, jgl, p in zip(grads, jax.tree.leaves(jg), tr.leaves(params)):
        assert g.dtype == p.dtype and str(jgl.dtype) == str(p.dtype).removeprefix("torch.")
        want = np.asarray(jgl, np.float32)
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0,
                                   atol=BF16_GRAD_RTOL * np.abs(want).max())


def test_chunked_ce_loss_masks_labels_and_ragged_chunks():
    """Labels below 0 add nothing and leave the count, S = 21 is not a
    multiple of the chunk of 8: loss and the gradients of h and of the
    (tied) table within the tolerances; all labels masked gives 0."""
    cfg, jcfg = cfgs("qwen2-0.5b")
    tree = interop.cache_to_numpy(registry.build(cfg).init(seed=6, device="cpu"))
    r = np.random.default_rng(7)
    h = r.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    labels = r.integers(-3, cfg.vocab, (2, 21)).astype(np.int32)
    assert (labels < 0).any()
    fn = jax.jit(jax.value_and_grad(
        lambda p, x, lb: JT.chunked_ce_loss(jcfg, p, x, lb, chunk=8), argnums=(0, 1)))
    jloss, (jgp, jgh) = fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(h), jnp.asarray(labels))
    params = interop.params_from_numpy(tree, device="cpu")
    th = torch.from_numpy(h).requires_grad_()
    tok = params["embed"]["tok"].requires_grad_()
    loss = T.chunked_ce_loss(cfg, params, th, torch.from_numpy(labels), chunk=8)
    gh, gtok = torch.autograd.grad(loss, (th, tok))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    close_leaf(gh.numpy(), np.asarray(jgh), "h")
    close_leaf(gtok.numpy(), np.asarray(jgp["embed"]["tok"]), "tok")
    with torch.no_grad():
        none = T.chunked_ce_loss(cfg, params, th, torch.full_like(torch.from_numpy(labels), -1))
    assert float(none) == 0.0


def test_attention_train_and_aux_loss_match_reference():
    """``layers.attention_train`` (RoPE, causal) and ``moe.aux_loss``
    (padded experts, gradient through the mean probabilities only): values
    and input / weight gradients."""
    cfg, jcfg = cfgs("qwen2-moe-a2.7b", n_experts_padded=8)
    tree = interop.cache_to_numpy(registry.build(cfg).init(seed=8, device="cpu"))
    lp = jax.tree.map(lambda a: a[0], tree["groups"]["layer0"])
    r = np.random.default_rng(9)
    x = r.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()

    def jfn(p, xx):
        att = JL.attention_train(jcfg, p["attn"], xx, jnp.asarray(pos))
        return jnp.sum(att * att) + JMOE.aux_loss(jcfg, p["ffn"], xx), \
            JMOE.aux_loss(jcfg, p["ffn"], xx)

    (jval, jaux), (jgp, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    p = tr.map(lambda a: a.requires_grad_(), interop.params_from_numpy(lp, device="cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    att = L.attention_train(cfg, p["attn"], tx, torch.from_numpy(pos))
    aux = MOE.aux_loss(cfg, p["ffn"], tx)
    val = torch.sum(att * att) + aux
    paths, leaves = zip(*tr.items(p))
    grads = torch.autograd.grad(val, (tx,) + leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(val.item(), float(jval), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=LOSS_RTOL)
    close_leaf(grads[0].numpy(), np.asarray(jgx), "x")
    jflat = {"/".join(str(q.key) for q in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    for k, g in zip(paths, grads[1:]):
        close_leaf(g.numpy(), jflat[k], k)
    assert np.abs(jflat["ffn/router"][:, cfg.n_experts:]).max() == 0  # padded experts


def test_remat_and_chunk_recompute_change_no_result():
    """remat "block" (each group recomputed in the backward) against "none",
    and the cross-entropy with or without recomputed chunks: the loss and
    every gradient bit for bit, with ``cfg.unroll`` (the unrolled
    attention) as without it."""
    cfg, _ = cfgs("jamba-1.5-large-398b", n_layers=2, attn_period=2)
    tree = interop.cache_to_numpy(registry.build(cfg).init(seed=11, device="cpu"))
    batch = make_batch(cfg, 12)
    for unroll in (False, True):
        results = [port_grads(cfg.replace(remat=remat, unroll=unroll), tree, batch)
                   for remat in ("block", "none")]
        (l0, m0, g0), (l1, m1, g1) = results
        assert l0 == l1 and m0 == m1
        assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_input_specs_match_reference():
    """``registry.input_specs`` for every arch id and shape name: the same
    tree of shapes and dtypes as the reference's ShapeDtypeStructs, built
    without allocating (the decode cache on the meta device)."""
    assert SHAPES == JSHAPES
    for arch in configs.all_archs():
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        for shape in SHAPES:
            got = {k: (v.shape, str(v.dtype).removeprefix("torch."))
                   for k, v in tr.items(registry.input_specs(cfg, shape))}
            want = {"/".join(str(p.key) for p in path): (tuple(v.shape), str(v.dtype))
                    for path, v in jax.tree_util.tree_flatten_with_path(
                        jregistry.input_specs(jcfg, shape))[0]}
            assert got == want, (arch, shape)
    spec = registry.input_specs(configs.get("kimi-k2-1t-a32b"), "decode_32k")
    assert isinstance(spec["cache"]["lens"], registry.Spec)


@pytest.mark.cuda
def test_matmul_f32_backward_on_the_card():
    """On a CUDA card: bf16 ``matmul_f32`` (cuBLAS's float32 output) has
    the reference's backward: each cotangent the float32 product of the
    other operand, upcast, rounded once to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cuBLAS out_dtype path runs only there")
    L.matmul_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for a_shape, b_shape in (((3, 5, 64), (64, 96)), ((4, 7, 32), (4, 32, 48))):
        a = torch.randn(a_shape, generator=gen, device="cuda").bfloat16().requires_grad_()
        b = torch.randn(b_shape, generator=gen, device="cuda").bfloat16().requires_grad_()
        out = L.matmul_f32(a, b)
        assert out.dtype == torch.float32
        g = torch.randn(out.shape, generator=gen, device="cuda")
        ga, gb = torch.autograd.grad(out, (a, b), g)
        a32, b32 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
        wa, wb = torch.autograd.grad(torch.matmul(a32, b32), (a32, b32), g)
        assert torch.equal(ga, wa.bfloat16()) and torch.equal(gb, wb.bfloat16())
