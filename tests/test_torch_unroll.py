"""The port's unrolled attention (``cfg.unroll``, ``cfg.causal_skip``: the
dry run's configs) against the JAX package, on the CPU, from the same
numpy inputs: ``layers.chunked_gqa_attention(unroll=True)`` case by case
(causal or not, causal skip, ``kv_offset`` 0 or not, several query chunks
with a padded last one), then ``loss_fn`` with its gradients and
``prefill`` at ``configs.reduced("qwen2-0.5b")`` with both flags, and
jamba reduced with ``variant="opt"``'s flags (unroll, causal skip, bf16 SSM
expansion). Every JAX result comes from one module-scoped run.

Tolerances: float32 within F32_RTOL of each result's largest entry (XLA and
torch sum the float32 products in other orders). bf16: the unrolled path
rounds the scores and the softmax weights to bf16, so a score whose float32
sum lands on the other side of a bf16 rounding point moves a weight by
2^-8 relative; BF16_ATOL (on unit-scale outputs, 4 bf16 ulps at 1.0) bounds
the attention output, BF16_LOGIT_RTOL the prefill logits relative to their
largest, and the greedy next token of the prefill must be equal. jamba's
bf16 SSM expansion in a float32 model: see its test.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

F32_RTOL = 1e-5
BF16_ATOL = 2.0 ** -6
BF16_LOGIT_RTOL = 2e-2
SSM_BF16_RTOL, SSM_BF16_GRAD_RTOL = 2e-3, 2e-2
Q_CHUNK = 16
# case -> (dtype, causal, causal_skip, kv_offset, S, Sk): S = 40 is two
# chunks of 16 and a padded one of 8; kv_offset < 0 puts Sk - S keys before
# the first query (no row masked whole)
ATTN_CASES = {
    "f32-causal": ("float32", True, False, 0, 40, 40),
    "f32-causal-skip": ("float32", True, True, 0, 40, 40),
    "f32-full-skip": ("float32", False, True, 0, 40, 40),
    "f32-causal-skip-offset": ("float32", True, True, -8, 40, 48),
    "bf16-causal-skip": ("bfloat16", True, True, 0, 40, 40),
    "bf16-full-offset": ("bfloat16", False, False, 3, 40, 24),
}
B, S = 1, 520  # two of the models' 512-token query chunks, the last padded


def _attn_inputs(dtype: str, S_: int, Sk: int, seed: int) -> tuple:
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, S_, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    if dtype == "bfloat16":  # values that bf16 holds exactly, in both packages
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (q, k, v))
    return q, k, v


def _cfgs(arch: str, dtype32: bool, **rep):
    cfg, jcfg = configs.reduced(arch).replace(**rep), jconfigs.reduced(arch).replace(**rep)
    if dtype32:
        cfg, jcfg = cfg.replace(dtype=torch.float32), jcfg.replace(dtype=jnp.float32)
    return cfg, jcfg


def _batch(cfg, seed: int, S_: int) -> dict:
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab, (B, S_)).astype(np.int32),
            "labels": r.integers(-1, cfg.vocab, (B, S_)).astype(np.int32)}


def _jtree(tree: dict, params: dict):
    """The port's init as the reference's params: bf16 leaves in bf16."""
    return jax.tree.map(lambda a, p: jnp.asarray(a, jnp.bfloat16) if p.dtype == torch.bfloat16
                        else jnp.asarray(a), tree, params)


def _jflat(grads) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(g, np.float32)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}


def _model_case(arch: str, dtype32: bool, seed: int, S_: int = S, **rep) -> dict:
    """Port and reference loss, gradients, prefill logits and greedy next
    token from the port's init and one seeded batch of S_ tokens."""
    cfg, jcfg = _cfgs(arch, dtype32, **rep)
    params = registry.build(cfg).init(seed=seed, device="cpu")
    tree = interop.cache_to_numpy(params)
    jparams = _jtree(tree, params)
    batch = _batch(cfg, seed + 1, S_)
    jm, m = jregistry.build(jcfg), registry.build(cfg)
    (jloss, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.detach().requires_grad_() for p in tr.leaves(params)]
    paths = [p for p, _ in tr.items(params)]
    loss, _ = m.loss_fn(tr.unflatten(paths, leaves), interop.params_from_numpy(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves)

    toks = batch["tokens"]
    jlog, _ = jax.jit(lambda p, b: jm.prefill(p, b))(jparams, {"tokens": jnp.asarray(toks)})
    jtoks, jlogs = [int(jnp.argmax(jlog[0]))], [np.asarray(jlog, np.float32)]
    with torch.no_grad():
        log, _ = m.prefill(params, {"tokens": torch.from_numpy(toks)})
        ptoks, plogs = [int(torch.argmax(log[0]))], [log.float().numpy()]
    return dict(loss=(float(loss.detach()), float(jloss)),
                grads=({p: g.float().numpy() for p, g in zip(paths, grads)}, _jflat(jg)),
                logits=(plogs, jlogs), tokens=(ptoks, jtoks))


@pytest.fixture(scope="module")
def ref():
    """Every reference result of the module, computed once."""
    out = {"attn": {}}
    for i, (case, (dt, causal, skip, off, S_, Sk)) in enumerate(ATTN_CASES.items()):
        q, k, v = _attn_inputs(dt, S_, Sk, 40 + i)
        jd = jnp.dtype(dt)
        fn = jax.jit(lambda q, k, v, causal=causal, skip=skip, off=off: JL.chunked_gqa_attention(
            q, k, v, causal=causal, q_chunk=Q_CHUNK, kv_offset=off, unroll=True,
            causal_skip=skip))
        out["attn"][case] = np.asarray(
            fn(*(jnp.asarray(a, jd) for a in (q, k, v))), np.float32)
    out["qwen2"] = _model_case("qwen2-0.5b", True, 60, unroll=True, causal_skip=True)
    out["qwen2-bf16"] = _model_case("qwen2-0.5b", False, 70, unroll=True, causal_skip=True)
    # jamba at 64 tokens: four Mamba chunks (the query chunks are qwen2's)
    out["jamba-opt"] = _model_case("jamba-1.5-large-398b", True, 80, 64, n_layers=2,
                                   attn_period=2, unroll=True, causal_skip=True, ssm_bf16=True)
    return out


def _close(got: np.ndarray, want: np.ndarray, rtol: float, what: str) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_unrolled_attention_matches_reference(ref, case):
    """``chunked_gqa_attention(unroll=True)``: the reference's unrolled
    numerics, chunk for chunk, with and without the causal skip."""
    dt, causal, skip, off, S_, Sk = ATTN_CASES[case]
    q, k, v = _attn_inputs(dt, S_, Sk, 40 + list(ATTN_CASES).index(case))
    td = getattr(torch, dt)
    got = L.chunked_gqa_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                  causal=causal, q_chunk=Q_CHUNK, kv_offset=off,
                                  unroll=True, causal_skip=skip)
    assert got.dtype == td and got.shape == (2, S_, 4, 16)
    want = ref["attn"][case]
    if dt == "float32":
        _close(got.numpy(), want, F32_RTOL, case)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_causal_skip_changes_nothing_in_float32():
    """The skip drops only keys that the causal mask removes: in float32
    the skipped and the full rectangle agree (a masked score adds an exact
    zero weight)."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs("float32", 40, 40, 41))
    full, skip = (L.chunked_gqa_attention(q, k, v, q_chunk=Q_CHUNK, unroll=True, causal_skip=s)
                  for s in (False, True))
    _close(skip.numpy(), full.numpy(), F32_RTOL, "skip")


def test_loss_and_gradients_unrolled_match_reference(ref):
    """``loss_fn`` and every gradient leaf at reduced qwen2-0.5b with
    ``unroll`` and ``causal_skip``, float32, S = 520 (two query chunks)."""
    r = ref["qwen2"]
    np.testing.assert_allclose(*r["loss"], rtol=F32_RTOL)
    grads, jgrads = r["grads"]
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        _close(g, jgrads[k], F32_RTOL, k)


def test_prefill_unrolled_matches_reference(ref):
    """Prefill logits in float32, and the greedy next token."""
    r = ref["qwen2"]
    for i, (got, want) in enumerate(zip(*r["logits"])):
        _close(got, want, F32_RTOL, f"logits {i}")
    assert r["tokens"][0] == r["tokens"][1]


def test_bf16_unrolled_matches_reference(ref):
    """The reference's own bf16 ``reduced()``: loss within 1e-3, prefill
    logits within BF16_LOGIT_RTOL of their largest, the same greedy
    token."""
    r = ref["qwen2-bf16"]
    np.testing.assert_allclose(*r["loss"], rtol=1e-3)
    for i, (got, want) in enumerate(zip(*r["logits"])):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_LOGIT_RTOL * float(np.abs(want).max()),
                                   err_msg=f"logits {i}")
    assert r["tokens"][0] == r["tokens"][1]


def test_jamba_opt_variant_matches_reference(ref):
    """jamba reduced to attention + Mamba/MoE with the dry run's ``opt``
    flags (unroll, causal skip, bf16 SSM expansion) in a float32 model:
    ``ssm_bf16`` rounds the Mamba expansion (dA, dBx) to bf16 in both
    packages, so where their float32 values differ by an ulp a rounding
    can flip (2^-8 relative): the loss within F32_RTOL still, the logits
    within SSM_BF16_RTOL and each gradient leaf within SSM_BF16_GRAD_RTOL
    of its scale (without ``ssm_bf16`` these agree to 4e-6); the same
    greedy tokens."""
    r = ref["jamba-opt"]
    np.testing.assert_allclose(*r["loss"], rtol=F32_RTOL)
    grads, jgrads = r["grads"]
    for k, g in grads.items():
        _close(g, jgrads[k], SSM_BF16_GRAD_RTOL, k)
    for i, (got, want) in enumerate(zip(*r["logits"])):
        _close(got, want, SSM_BF16_RTOL, f"logits {i}")
    assert r["tokens"][0] == r["tokens"][1]
