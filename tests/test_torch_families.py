"""The port's model families against the JAX package, on the CPU: configs,
init trees and parameter counts for all ten architectures; M-RoPE,
LayerNorm, GeGLU and GELU; the MoE FFN's routing, capacity and drops; the
Mamba and xLSTM mixers from prefill into decode; and each of the nine
architectures beyond qwen2-0.5b end to end (prefill, then two decode
steps), reduced, in float32 with 8-token pages.

Both packages compute from the same weights: the port's init, carried to
the JAX package as numpy (``interop.cache_to_numpy``) and back into the
port (``interop.params_from_numpy``). Tolerances, as
``tests/test_torch_model.py``: 1e-5 on one layer, 1e-4 on the whole
model (float32 sums in another order than XLA's, cos/sin in the last bit;
the Mamba scan runs step by step where the reference runs a parallel
``associative_scan``). Routing choices and the MoE kept mask must be
equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402

ATOL_LAYER, ATOL_MODEL = 1e-5, 1e-4
FAMILIES = tuple(a for a in configs.all_archs() if a != "qwen2-0.5b")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol, err_msg=what)


def f32(arch: str):
    """(port cfg, JAX cfg): reduced, float32, 8-token pages."""
    return (configs.reduced(arch).replace(dtype=torch.float32, page_size=8),
            jconfigs.reduced(arch).replace(dtype=jnp.float32, page_size=8))


def both_params(cfg, seed: int):
    """The port's init on the CPU, as (port params, JAX params)."""
    tree = interop.cache_to_numpy(registry.build(cfg).init(seed=seed, device="cpu"))
    return interop.params_from_numpy(tree, device="cpu"), jax.tree.map(jnp.asarray, tree)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def layer0(tree):
    """Group 0's slice of a stacked tree."""
    return {k: layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


# --------------------------------------------------------------------------
# configs and init trees
# --------------------------------------------------------------------------
def test_configs_and_param_counts_match_reference():
    """The published configs field for field, and their exact and active
    parameter counts, eligibility and shape cells."""
    assert configs.SHAPE_SPECS == jconfigs.SHAPE_SPECS and configs.SHAPES == jconfigs.SHAPES
    for arch in configs.all_archs():
        for get in ("get", "reduced"):
            j, p = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
            assert ({f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
                    == {f.name: getattr(p, f.name) for f in dataclasses.fields(p)
                        if f.name != "dtype"}), arch
            assert p.dtype == torch.bfloat16
            assert (p.param_count(), p.active_param_count(), p.subquadratic, p.shapes(),
                    p.attn_layers, p.n_groups) == (
                j.param_count(), j.active_param_count(), j.subquadratic, j.shapes(),
                j.attn_layers, j.n_groups), (arch, get)
        assert configs.get(arch.replace("-", "_").replace(".", "_")) == configs.get(arch)


def test_init_trees_match_reference():
    """Every arch's init (reduced, bf16): the reference's keys, shapes and
    dtypes, and as many parameters as ``param_count`` says."""
    for arch in configs.all_archs():
        cfg, jcfg = configs.reduced(arch), jconfigs.reduced(arch)
        got = dict(flat(registry.build(cfg).init(seed=1, device="cpu")))
        want = jax.eval_shape(lambda: jregistry.build(jcfg).init(jax.random.PRNGKey(0)))
        want = {"/".join(str(getattr(p, "key", p)) for p in k): v
                for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert set(got) == set(want), (arch, set(got) ^ set(want))
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, (arch, k)
            assert str(v.dtype).split(".")[-1] == str(want[k].dtype), (arch, k, v.dtype)
        assert sum(v.numel() for v in got.values()) == cfg.param_count(), arch


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_mrope_with_distinct_streams_matches_reference():
    cfg, jcfg = f32("qwen2-vl-2b")
    r = np.random.default_rng(30)
    x = r.standard_normal((2, 5, 4, cfg.hd)).astype(np.float32)
    pos3 = np.stack([r.permutation(40)[:10].reshape(2, 5) for _ in range(3)]).astype(np.int32)
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    close(L.apply_mrope(t(x), t(pos3), cfg.rope_theta, cfg.mrope_sections).numpy(),
          jax.jit(JL.apply_mrope, static_argnums=(2, 3))(
              jnp.asarray(x), jnp.asarray(pos3), jcfg.rope_theta, jcfg.mrope_sections),
          ATOL_LAYER, "mrope")
    # (B, S) positions: three equal streams, on both sides
    close(L.rotate(cfg, t(x), t(pos3[1])).numpy(),
          jax.jit(JL.rotate, static_argnums=0)(jcfg, jnp.asarray(x), jnp.asarray(pos3[1])),
          ATOL_LAYER, "text-only")


def test_layernorm_geglu_gelu_and_learned_positions_match_reference():
    r = np.random.default_rng(31)
    for arch in ("whisper-tiny", "gemma-7b"):  # layernorm + gelu, rmsnorm + geglu
        cfg, jcfg = f32(arch)
        params, jparams = both_params(cfg, seed=2)
        lp, jlp = layer0(params["groups"])["layer0"], jax.tree.map(
            lambda a: a[0], jparams["groups"])["layer0"]
        x = r.standard_normal((2, 3, cfg.d_model)).astype(np.float32) * 3 + 1
        # a norm with a non-trivial scale and bias
        norm = {k: t(r.standard_normal(v.shape).astype(np.float32)) for k, v in lp["norm1"].items()}
        # the reference's layers jitted (one compile each; eager compiles every op)
        norm_fn, mlp_fn, unembed_fn = (jax.jit(f, static_argnums=0) for f in (
            JL.apply_norm, JL.apply_mlp, JL.unembed))
        close(L.apply_norm(cfg, norm, t(x)).numpy(),
              norm_fn(jcfg, {k: jnp.asarray(v.numpy()) for k, v in norm.items()},
                      jnp.asarray(x)), ATOL_LAYER, f"{arch} norm")
        close(L.apply_mlp(cfg, lp["ffn"], t(x)).numpy(),
              mlp_fn(jcfg, jlp["ffn"], jnp.asarray(x)), ATOL_LAYER, f"{arch} mlp")
        close(L.unembed(cfg, params["embed"], t(x)).numpy(),
              unembed_fn(jcfg, jparams["embed"], jnp.asarray(x)), ATOL_LAYER, f"{arch} unembed")
    toks = r.integers(0, cfg.vocab, size=(3, 1)).astype(np.int32)
    cfg, jcfg = f32("whisper-tiny")
    params, jparams = both_params(cfg, seed=3)
    lens = np.array([0, 17, cfg.max_seq + 5], np.int32)  # past the table: clamped
    close(T._embed_tokens(cfg, params, t(toks), lens=t(lens)).numpy(),
          JT._embed_tokens(jcfg, jparams, jnp.asarray(toks), None, lens=jnp.asarray(lens)),
          0.0, "learned positions")


# --------------------------------------------------------------------------
# MoE: routing, capacity and drops
# --------------------------------------------------------------------------
def _reference_routing(jcfg, jp, x):
    """The reference's own steps (``repro.models.moe.apply_moe``) up to the
    kept mask, in jnp."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = xt @ jp["router"]
    E = logits.shape[-1]
    logits = jnp.where(jnp.arange(E)[None] >= jcfg.n_experts, -jnp.inf, logits)
    _, experts = jax.lax.top_k(logits, jcfg.top_k)
    T_ = xt.shape[0]
    cap = min(max(1, int(T_ * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor)),
              T_ * jcfg.top_k)
    onehot = jax.nn.one_hot(experts.reshape(-1), E, dtype=jnp.int32)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    return np.asarray(experts), np.asarray(pos < cap), cap


@pytest.mark.parametrize("shape", [(2, 7), (3, 1)])  # prefill-like; decode: T = max_seqs
def test_moe_routing_capacity_and_drops_match_reference(shape):
    cfg, jcfg = f32("qwen2-moe-a2.7b")
    cfg, jcfg = cfg.replace(capacity_factor=1.25), jcfg.replace(capacity_factor=1.25)
    params, jparams = both_params(cfg, seed=4)
    p = layer0(params["groups"])["layer1" if cfg.group_size > 1 else "layer0"]["ffn"]
    jp = jax.tree.map(lambda a: a[0], jparams["groups"])[
        "layer1" if cfg.group_size > 1 else "layer0"]["ffn"]
    # two router columns equal: their ties go to the lower expert in both
    p["router"][:, 3] = p["router"][:, 1]
    jp = {**jp, "router": jnp.asarray(p["router"].numpy())}
    r = np.random.default_rng(32)
    x = r.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    experts, keep, cap = _reference_routing(jcfg, jp, x)
    _, got_e = MOE.route(cfg, p, t(x).reshape(-1, cfg.d_model))
    assert np.array_equal(got_e.numpy(), experts)
    _, _, got_keep = MOE.dispatch_slots(cfg, got_e, MOE.capacity(cfg, x.size // cfg.d_model))
    assert MOE.capacity(cfg, x.size // cfg.d_model) == cap
    assert np.array_equal(got_keep.numpy(), keep) and not keep.all()  # drops happen
    close(MOE.apply_moe(cfg, p, t(x)).numpy(),
          jax.jit(JMOE.apply_moe, static_argnums=0)(jcfg, jp, jnp.asarray(x)), ATOL_LAYER, "moe")


# --------------------------------------------------------------------------
# recurrent mixers: prefill, then decode from its state
# --------------------------------------------------------------------------
def _mixer_runs(cfg, jcfg, p, jp, prefill, jprefill, decode, jdecode, seed):
    jprefill, jdecode = (jax.jit(f, static_argnums=0) for f in (jprefill, jdecode))
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, 19, cfg.d_model)).astype(np.float32)  # 19: a partial chunk
    got, st = prefill(cfg, p, t(x))
    want, jst = jprefill(jcfg, jp, jnp.asarray(x))
    out = [("prefill", got, want, st, jst)]
    for i in range(2):
        xd = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, st = decode(cfg, p, t(xd), st)
        want, jst = jdecode(jcfg, jp, jnp.asarray(xd), jst)
        out.append((f"decode{i}", got, want, st, jst))
    for what, got, want, st, jst in out:
        close(got.numpy(), want, ATOL_LAYER, what)
        assert set(st) == set(jst)
        for k in st:
            close(st[k].numpy(), jst[k], ATOL_LAYER, f"{what} state {k}")


def test_mamba_prefill_then_decode_matches_reference():
    cfg, jcfg = f32("jamba-1.5-large-398b")
    params, jparams = both_params(cfg, seed=5)
    p = layer0(params["groups"])["layer1"]["mamba"]
    jp = jax.tree.map(lambda a: a[0], jparams["groups"])["layer1"]["mamba"]
    _mixer_runs(cfg, jcfg, p, jp, M.mamba_prefill, JM.mamba_prefill, M.mamba_decode,
                JM.mamba_decode, 33)


def test_xlstm_prefill_then_decode_matches_reference():
    cfg, jcfg = f32("xlstm-1.3b")
    params, jparams = both_params(cfg, seed=6)
    lp, jlp = layer0(params["groups"]), jax.tree.map(lambda a: a[0], jparams["groups"])
    assert "mlstm" in lp["layer0"] and "slstm" in lp["layer1"]
    _mixer_runs(cfg, jcfg, lp["layer0"]["mlstm"], jlp["layer0"]["mlstm"], X.mlstm_prefill,
                JX.mlstm_prefill, X.mlstm_decode, JX.mlstm_decode, 34)
    _mixer_runs(cfg, jcfg, lp["layer1"]["slstm"], jlp["layer1"]["slstm"], X.slstm_prefill,
                JX.slstm_prefill, X.slstm_decode, JX.slstm_decode, 35)


# --------------------------------------------------------------------------
# every family end to end: prefill, then two decode steps
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_runs():
    """arch -> [(stage, (port logits, port cache), (JAX logits, JAX cache))]:
    two prompts of 13 tokens into pages of 8, then two decode steps."""
    out = {}
    for i, arch in enumerate(FAMILIES):
        cfg, jcfg = f32(arch)
        params, jparams = both_params(cfg, seed=10 + i)
        r = np.random.default_rng(40 + i)
        B, S = 2, 13
        batch = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.mrope:
            batch["positions"] = r.integers(0, 30, (3, B, S)).astype(np.int32)
        if cfg.encdec:
            batch["frames"] = r.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
        steps = r.integers(0, cfg.vocab, (2, B, 1)).astype(np.int32)
        jm, m = jregistry.build(jcfg), registry.build(cfg)
        jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=24))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        log, cache = m.prefill(params, {k: t(v) for k, v in batch.items()}, max_seq=24)
        runs = [("prefill", (log.numpy(), interop.cache_to_numpy(cache)),
                 (np.asarray(jlog), jax.tree.map(np.asarray, jcache)))]
        jdec = jax.jit(jm.decode)
        for k, s in enumerate(steps):
            jlog, jcache = jdec(jparams, jcache, jnp.asarray(s))
            log, cache = m.decode(params, cache, t(s))
            runs.append((f"decode{k}", (log.numpy(), interop.cache_to_numpy(cache)),
                         (np.asarray(jlog), jax.tree.map(np.asarray, jcache))))
        out[arch] = runs
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_matches_reference(model_runs, arch):
    """Logits and every cache leaf (pages, Mamba / xLSTM states, encoder
    K/V) within 1e-4; the block table and lengths equal."""
    for stage, (log, cache), (jlog, jcache) in model_runs[arch]:
        close(log, jlog, ATOL_MODEL, f"{stage} logits")
        got, want = dict(flat(cache)), dict(flat(jcache))
        assert set(got) == set(want), (stage, set(got) ^ set(want))
        for k in ("btab", "lens"):
            assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype, (stage, k)
        for k, v in got.items():
            close(v, want[k], ATOL_MODEL, f"{stage} {k}")
