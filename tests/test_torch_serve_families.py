"""The port's serving engine against the JAX package's for the families
beyond the dense one, on the CPU: whisper-tiny (encoder-decoder, zero stub
frames), xlstm-1.3b (no attention layer: no pages, no attention mass),
jamba (attention + Mamba + MoE) and qwen2-vl (M-RoPE), each reduced, in
float32 with 8-token pages, from the same weights (the port's init, carried
to both packages as numpy by ``interop``).

Token streams, the placement state and ``stats()`` must be identical, as
``tests/test_torch_serve.py`` holds the dense family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_jax_core import jitted_core  # noqa: E402  (the reference core, jitted)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.kernels import registry as kregistry  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine, scheduler  # noqa: E402

ARCHS = ("whisper-tiny", "xlstm-1.3b", "jamba-1.5-large-398b", "qwen2-vl-2b")
N_REQUESTS, PROMPT_LEN, MAX_NEW = 4, 14, 6


def state_to_numpy(state, port: bool) -> dict:
    if port:
        return interop.state_to_numpy(state)
    d = {f.name: np.asarray(getattr(state, f.name))
         for f in dataclasses.fields(state) if f.name != "stats"}
    d["stats"] = {k: np.asarray(v) for k, v in state.stats.items()}
    return d


def make_engine(mod, sched, model, params, **kw):
    ecfg = mod.EngineConfig(
        max_seqs=3, max_seq_len=48, pages_per_block=4, near_fraction=0.4,
        sched=sched.SchedulerConfig(max_seqs=3, maintenance_every=2, reserve_tokens=8))
    return mod.Engine(model, params, ecfg, **kw)


def serve(eng, sched, vocab: int) -> list:
    rng = np.random.default_rng(4)
    reqs = [sched.Request(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN).tolist(),
                          max_new=MAX_NEW) for i in range(N_REQUESTS)]
    for r in reqs:
        eng.sched.submit(r)
    eng.run(max_steps=100)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def runs():
    """arch -> {"jax": ..., "port": ...}: tokens, stats, placement state."""
    out = {}
    for arch in ARCHS:
        cfg = configs.reduced(arch).replace(dtype=torch.float32, page_size=8)
        jcfg = jconfigs.reduced(arch).replace(dtype=jnp.float32, page_size=8)
        tree = interop.cache_to_numpy(registry.build(cfg).init(seed=5, device="cpu"))
        params = interop.params_from_numpy(tree, device="cpu")
        jparams = jax.tree.map(jnp.asarray, tree)
        jmodel = jregistry.build(jcfg)
        # the reference engine prefills eagerly; jitted, its compiles are fewer
        jmodel = dataclasses.replace(jmodel, prefill=jax.jit(
            jmodel.prefill, static_argnames=("max_seq", "n_pool")))
        out[arch] = {}
        for name, mod, sched, model, p, kw in (
                ("jax", jengine, jsched, jmodel, jparams, {}),
                ("port", engine, scheduler, registry.build(cfg), params, {"device": "cpu"})):
            with jitted_core():  # the reference's integer core (tests/torch_jax_core.py)
                eng = make_engine(mod, sched, model, p, **kw)
                toks = serve(eng, sched, cfg.vocab)
            out[arch][name] = dict(tokens=toks, stats=eng.stats(),
                                   state=state_to_numpy(eng.pstate, name == "port"),
                                   btab=np.asarray(eng._model_btab_from_gpt()))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(runs, arch):
    want, got = runs[arch]["jax"], runs[arch]["port"]
    assert got["tokens"] == want["tokens"]
    assert all(len(t) == MAX_NEW for t in got["tokens"])
    assert got["stats"] == want["stats"]
    for k, w in want["state"].items():
        if k == "stats":
            for s in w:
                assert np.array_equal(w[s], got["state"][k][s]) and w[s].dtype == \
                    got["state"][k][s].dtype, s
        else:
            assert w.dtype == got["state"][k].dtype and np.array_equal(w, got["state"][k]), k
    assert np.array_equal(got["btab"], want["btab"])
    if arch == "xlstm-1.3b":  # no attention layer: no mass, so nothing recorded
        assert got["stats"]["consolidated_pages"] == 0


def test_launch_serve_runs_every_family_on_the_cpu(capsys):
    before = kregistry.launch_counts()
    for arch in ("whisper-tiny", "qwen2-moe-a2.7b"):
        stats = launch_serve.main(["--arch", arch, "--device", "cpu", "--reduced",
                                   "--requests", "2", "--max-new", "3", "--prompt-len", "9",
                                   "--max-seq-len", "32"])
        assert set(stats) >= {"hit_rate", "consolidated_pages"}
    out = capsys.readouterr().out
    assert "[serve] whisper-reduced: 2 requests, 6 tokens" in out
    assert "[serve] qwen2-moe-reduced: 2 requests, 6 tokens" in out
    assert kregistry.launch_counts() == before  # CPU tensors launch nothing
