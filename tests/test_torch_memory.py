"""The port's tiered memory substrate against the JAX package, on the CPU:
the embedding store, the paged KV cache and the MoE expert store run the
same ``record_*`` / ``maintenance`` sequence on the same numpy data in both
packages, each over a reduced ArchConfig built in its own package.

The core is exact, so the placement states must be identical leaf by leaf,
dtypes included, and so must every lookup, read-back and metric. The JAX
runs are made once per module (``ref``); the stores run the kernels' plain
versions here, and through the CUDA kernels in ``chip_smoke.py``'s memory
phase on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_jax_core import jitted_core  # noqa: E402  (the reference core, jitted)

import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.memory.embedding import EmbedSpec as JEmbedSpec  # noqa: E402
from repro.memory.embedding import TieredEmbeddingStore as JEmbedStore  # noqa: E402
from repro.memory.kvcache import KVSpec as JKVSpec, TieredKVCache as JKVCache  # noqa: E402
from repro.memory.moe_store import ExpertStoreSpec as JExpertSpec  # noqa: E402
from repro.memory.moe_store import TieredExpertStore as JExpertStore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.memory.embedding import EmbedSpec, TieredEmbeddingStore  # noqa: E402
from repro_torch.memory.kvcache import KVSpec, TieredKVCache  # noqa: E402
from repro_torch.memory.moe_store import ExpertStoreSpec, TieredExpertStore  # noqa: E402

# the reduced internlm2 and kimi-k2 of the JAX package, built in the port
DENSE = ArchConfig(name="internlm2-reduced", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                   dtype=torch.float32)
MOE = ArchConfig(name="kimi-k2-reduced", family="moe", n_layers=2, d_model=64, n_heads=4,
                 n_kv_heads=2, d_ff=32, vocab=256, n_experts=8, n_shared_experts=1,
                 top_k=2, head_dim=16, capacity_factor=8.0)
EMBED = dict(rows_per_page=4, hp_ratio=8, near_fraction=0.3, cl=4)
KV = dict(max_seqs=2, max_seq_len=256, group_tokens=4, hp_ratio=4, near_fraction=0.4, cl=3)
ROUNDS, KV_WINDOWS, MOE_ROUNDS = 4, 6, 12


def jax_arch(name):
    return jconfigs.reduced(name).replace(dtype=jnp.float32)


def jax_state(state) -> dict:
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def assert_same_state(want, got_state) -> None:
    got = interop.state_to_numpy(got_state)
    assert set(want) == set(got)
    for k in want:
        pairs = want[k].items() if k == "stats" else [(k, want[k])]
        for name, w in pairs:
            g = got["stats"][name] if k == "stats" else got[k]
            assert w.dtype == g.dtype and w.shape == g.shape, (name, w.dtype, g.dtype)
            assert np.array_equal(w, g), name


def same(want, got) -> None:
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    assert np.array_equal(want.view(np.uint8), got.view(np.uint8))


def embed_inputs():
    r = np.random.default_rng(3)
    table = r.standard_normal((DENSE.vocab, DENSE.d_model)).astype(np.float32)
    batches = [np.minimum(r.zipf(1.3, size=512) - 1, DENSE.vocab - 1)
               for _ in range(ROUNDS)]
    probe = np.concatenate([r.integers(0, DENSE.vocab, 60), [-1, 0, 255, 256, 999]])
    return table, batches, probe.astype(np.int32).reshape(5, 13)


def kv_inputs(spec):
    r = np.random.default_rng(5)
    a = spec.arch
    shape = (spec.groups_per_seq, a.n_attn_layers, a.n_kv_heads, spec.group_tokens, a.hd)
    return [(r.standard_normal(shape).astype(np.float32),
             r.standard_normal(shape).astype(np.float32)) for _ in range(spec.max_seqs)]


def kv_mass(spec, seq_groups, window):
    """Skewed attention mass: one hot group per tier block, plus a few warm
    ones that move from window to window."""
    hot = np.concatenate([g[:: spec.hp_ratio] for g in seq_groups])
    warm = np.concatenate([g[window % 3:: 7] for g in seq_groups])
    ids = np.concatenate([hot, warm])
    mass = np.concatenate([np.full(hot.shape, 0.9), np.full(warm.shape, 0.013 * window)])
    return ids, mass


def moe_selections():
    r = np.random.default_rng(9)
    hot = np.asarray([0, 3, 5])
    return [np.concatenate([np.repeat(hot, 50), r.integers(0, MOE.n_experts, 3)])
            for _ in range(MOE_ROUNDS)]


def run_embed(store, batches, probe, as_ids):
    looks, metrics = [store.lookup(as_ids(probe))], []
    for b in batches:
        store.record_batch(b)
        store.maintenance()
        looks.append(store.lookup(as_ids(probe)))
        metrics.append((store.near_usage(), store.hit_rate()))
    return looks, metrics


def run_kv(cache, inputs, as_arr, use_gpac=True):
    for seq, (k, v) in enumerate(inputs):
        cache.append_groups(seq, as_arr(k), as_arr(v))
    groups = [cache.seq_groups(s) for s in range(len(inputs))]
    for w in range(KV_WINDOWS):
        cache.record_attention_mass(*kv_mass(cache.spec, groups, w))
        cache.maintenance(use_gpac=use_gpac)
    ids = np.concatenate(groups + [[-1, 10_000]]).astype(np.int32)
    return cache.read_groups(as_arr(ids)), cache.stats()


def run_moe(store, selections):
    near = []
    for sel in selections:
        store.record_routing(sel)
        store.maintenance()
        near.append(store.near_experts())
    return near, store.hit_rate()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's runs, once per module (its integer engine core
    jitted: tests/torch_jax_core.py)."""
    with jitted_core():
        return _ref_runs()


def _ref_runs() -> dict:
    out = {}
    table, batches, probe = embed_inputs()
    st = JEmbedStore(JEmbedSpec(arch=jax_arch("internlm2-20b"), **EMBED), jnp.asarray(table))
    out["embed"] = run_embed(st, batches, probe, jnp.asarray) + (jax_state(st.state),)
    spec = JKVSpec(arch=jax_arch("internlm2-20b"), **KV)
    for use_gpac in (True, False):
        kv = JKVCache(spec)
        (k, v), stats = run_kv(kv, kv_inputs(spec), jnp.asarray, use_gpac)
        out[f"kv_{use_gpac}"] = (np.asarray(k), np.asarray(v), stats, jax_state(kv.state))
    es = JExpertStore(JExpertSpec(arch=jconfigs.reduced("kimi-k2-1t-a32b"), near_fraction=0.5))
    out["moe"] = run_moe(es, moe_selections()) + (jax_state(es.state),)
    return out


@pytest.fixture(scope="module")
def port():
    out = {}
    table, batches, probe = embed_inputs()
    st = TieredEmbeddingStore(EmbedSpec(arch=DENSE, **EMBED), torch.from_numpy(table),
                              device="cpu")
    out["embed"] = run_embed(st, batches, probe, torch.from_numpy) + (st,)
    spec = KVSpec(arch=DENSE, **KV)
    for use_gpac in (True, False):
        kv = TieredKVCache(spec, device="cpu")
        (k, v), stats = run_kv(kv, kv_inputs(spec), torch.from_numpy, use_gpac)
        out[f"kv_{use_gpac}"] = (k, v, stats, kv)
    es = TieredExpertStore(ExpertStoreSpec(arch=MOE, near_fraction=0.5), device="cpu")
    out["moe"] = run_moe(es, moe_selections()) + (es,)
    return out


def test_arch_properties_match_reference():
    """e_pad and n_attn_layers (the stores' geometry) and the other derived
    properties, on every reduced config of the JAX package, rebuilt in the
    port from the same fields."""
    for name in jconfigs.all_archs():
        j = jconfigs.reduced(name)
        fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        p = ArchConfig(**{**fields, "dtype": torch.float32})
        for prop in ("hd", "is_moe", "e_pad", "group_size", "n_groups", "attn_layers",
                     "n_attn_layers"):
            assert getattr(p, prop) == getattr(j, prop), (name, prop)
    assert DENSE.n_attn_layers == 2 and MOE.e_pad == 8


def test_embedding_lookups_match(ref, port):
    """Every lookup, before and after each maintenance round, bit for bit
    (-1 and ids past the vocabulary give zero rows)."""
    want, got = ref["embed"][0], port["embed"][0]
    assert len(want) == len(got) == ROUNDS + 1
    for w, g in zip(want, got):
        same(w, g)
    table, _, probe = embed_inputs()
    ok = (probe >= 0) & (probe < DENSE.vocab)
    assert np.array_equal(got[-1].numpy()[ok], table[probe[ok]])
    assert not got[-1].numpy()[~ok].any()


def test_embedding_state_and_metrics_match(ref, port):
    assert_same_state(ref["embed"][2], port["embed"][2].state)
    assert ref["embed"][1] == port["embed"][1]
    assert port["embed"][2].state.stats["consolidated_pages"] > 0  # GPAC did move rows


@pytest.mark.parametrize("use_gpac", [True, False])
def test_kvcache_matches(ref, port, use_gpac):
    """State, read-back (through the translation, with an invalid id) and
    stats() after append, skewed mass and maintenance windows."""
    wk, wv, wstats, wstate = ref[f"kv_{use_gpac}"]
    gk, gv, gstats, cache = port[f"kv_{use_gpac}"]
    assert_same_state(wstate, cache.state)
    same(wk, gk)
    same(wv, gv)
    assert wstats == gstats
    if use_gpac:
        assert gstats["consolidated_pages"] > 0


def test_kvcache_reads_back_what_was_appended(port):
    gk, gv, _, cache = port["kv_True"]
    inputs = kv_inputs(cache.spec)
    n = cache.spec.groups_per_seq
    for seq, (k, v) in enumerate(inputs):
        assert np.array_equal(gk[seq * n:(seq + 1) * n].numpy(), k)
        assert np.array_equal(gv[seq * n:(seq + 1) * n].numpy(), v)
    assert not gk[-2:].any() and not gv[-2:].any()


def test_expert_store_matches(ref, port):
    wnear, whit, wstate = ref["moe"]
    gnear, ghit, store = port["moe"]
    assert_same_state(wstate, store.state)
    assert len(wnear) == len(gnear)
    for w, g in zip(wnear, gnear):
        assert np.array_equal(w, g)
    assert whit == ghit
    assert {0, 3, 5} <= set(gnear[-1].tolist())


def test_stores_refuse_cpu_fallback(monkeypatch):
    """Without a card the stores raise unless given device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredKVCache(KVSpec(arch=DENSE, **KV))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredExpertStore(ExpertStoreSpec(arch=MOE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredEmbeddingStore(EmbedSpec(arch=DENSE, **EMBED),
                             torch.zeros((DENSE.vocab, DENSE.d_model)))
