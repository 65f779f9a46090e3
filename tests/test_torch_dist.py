"""The port's data-parallel training (``models/dist.py``, the training half
of ``launch/mesh.py``, ``launch/sharding.py``, and the trainer, pipeline and
checkpoints under a mesh) against the JAX package, on the CPU.

Specs: ``param_specs`` (FSDP off and at its default), ``opt_specs`` (AdamW
and Adafactor states, with and without the error state), ``batch_specs``
and ``cache_specs`` equal the reference's entry for entry for every arch id
at full size, on stub meshes (no process group), the port's shapes on the
``meta`` device against ``jax.eval_shape`` of the reference's.

Training: one 4-rank job over gloo (``tests/torch_dist_cases.py``, started
once by the port's ``multihost.launch``) runs each case for 3 steps from
the port's init; its ranks 0 and 1 also form a 2-rank mesh. Every rank of a
mesh must be bit-identical to every other after every step. Each step is
held to the JAX package's one-device step over the same global batch from
the same params and state, in two halves as ``test_torch_trainer.py``
holds a step: the gradients the optimizer receives (summed over the ranks)
and the loss against the reference's (``jax.value_and_grad`` of its loss,
micro-batches accumulated as its step does) within GRAD_RTOL of each leaf's
scale and LOSS_RTOL; then the reference's jitted ``make_train_step`` given
exactly those gradients (a loss linear in the params) against the port's
params, optimizer state and metrics after the step within OPT_RTOL, the
error state bit for bit. (A whole step from the model's own gradients
would multiply their float noise: AdamW's first update is about
sign(gradient), and int8 codes flip at rounding boundaries.)
"""
import functools
import json
import os
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import torch_dist_cases as C  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models.dist import NO_DIST as JNO_DIST  # noqa: E402
from repro.models.dist import Dist as JDist  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import multihost, sharding  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import dist as pdist  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.train import checkpoint, optimizer, trainer  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL, GRAD_RTOL, OPT_RTOL = 1e-5, 1e-4, 1e-5  # test_torch_train / test_torch_trainer


class StubMesh:
    """Quacks like a mesh for the spec rules (axis sizes only)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"pod2-data16-model16": dict(pod=2, data=16, model=16),
          "data4-model2": dict(data=4, model=2)}


def dists(mesh: str) -> tuple:
    """(the reference's Dist, the port's) on a stub mesh."""
    axes = MESHES[mesh]
    dp = tuple(a for a in axes if a in ("pod", "data"))
    return JDist(StubMesh(**axes), dp, "model"), pdist.Dist(StubMesh(**axes), dp, "model")


def jpath(path) -> str:
    return "/".join(str(getattr(p, "key", p)) for p in path)


def entries(spec) -> tuple:
    """A spec's entries, a one-name tuple as that name (jax 0.9's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``; 0.4's does not)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def same_specs(got, want, what: str) -> None:
    """Two spec trees, entry for entry."""
    want = {jpath(p): entries(s) for p, s in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP))[0]}
    got = dict(tr.items(got))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        assert isinstance(got[k], pdist.P) and entries(got[k]) == w, (what, k, got[k], w)


@functools.lru_cache(maxsize=None)
def shapes(arch: str) -> tuple:
    """(the port's params on ``meta``, the reference's eval_shape) at full size."""
    return (registry.param_shapes(configs.get(arch)),
            jax.eval_shape(jregistry.build(jconfigs.get(arch)).init, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def opt_states(arch: str, name: str) -> tuple:
    """(the port's train state on ``meta``, the reference's eval_shape) with
    optimizer ``name`` and the error state, at full size."""
    got, want = shapes(arch)
    tcfg = trainer.TrainConfig(compress_grads=True, opt=optimizer.OptConfig(name=name))
    jtcfg = jtrainer.TrainConfig(compress_grads=True, opt=joptimizer.OptConfig(name=name))
    return (trainer.init_train_state(tcfg, got),
            jax.eval_shape(lambda p: jtrainer.init_train_state(jtcfg, p), want))


# --------------------------------------------------------------------------
# Dist and the meshes
# --------------------------------------------------------------------------
def test_dist_fit_spec_axis_size_and_constrain():
    """``axis_size`` and ``fit_spec``'s divisibility fallback equal the
    reference's; without a mesh every helper is the identity."""
    for mesh in MESHES:
        jd, d = dists(mesh)
        for axes in ("data", "model", jd.dp, ("model",) + jd.dp):
            assert d.axis_size(axes) == jd.axis_size(axes), (mesh, axes)
        for shape, spec in (((32, 15), (jd.dp, "model")), ((1, 64, 7), (jd.dp, None, "model")),
                            ((48,), ("model",)), ((6, 8, 2), (None, jd.dp)), ((), ())):
            assert entries(d.fit_spec(shape, pdist.P(*spec))) == \
                entries(jd.fit_spec(shape, JP(*spec))), (mesh, shape, spec)
        assert d.sharding((64, 8), ("data", None)) == d.fit_spec((64, 8), ("data", None))
    x = torch.arange(6.0)
    nd = pdist.NO_DIST
    assert nd.constrain(x, "data") is x and nd.sharding((4,), ("data",)) is None
    assert (nd.axis_size("data"), nd.dp_size(), nd.dp_rank()) == (1, 1, 0)
    assert nd.psum(x, "loss") is x and nd.all_gather(x, "moe_counts").shape == (1, 6)
    assert dists("data4-model2")[1].constrain(x, "data") is x
    assert repr(pdist.P(None, ("pod", "data"))) == "P(None, ('pod', 'data'))"


def test_train_mesh_errors_and_the_one_rank_mesh():
    """The reference's axis validation; a mesh whose size differs from the
    job's raises naming both counts (``make_production_mesh`` and
    ``launch.train --mesh`` in a one-process job); ``dp_axes``; the
    one-rank mesh (a gloo group of its own) and its groups."""
    for bad in (dict(data=0), dict(model=0), dict(pods=0)):
        with pytest.raises(ValueError, match="axis sizes must be >= 1"):
            mesh_mod.train_mesh(**{"data": 2, "model": 2, **bad}, device="cpu")
    with pytest.raises(ValueError, match=r"data=2 x model=1 mesh needs 2 ranks; this job has 1"):
        mesh_mod.train_mesh(2, 1, device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks; this job has 1"):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh", "single", "--steps", "1"])
    assert mesh_mod.dp_axes(StubMesh(pod=2, data=16, model=16)) == ("pod", "data")
    assert mesh_mod.dp_axes(StubMesh(data=16, model=16)) == ("data",)
    assert not torch.distributed.is_initialized()
    try:
        m = mesh_mod.train_mesh(1, 1, pods=1, device="cpu")
        d = mesh_mod.make_dist(m)
        assert (m.axis_names, m.shape, m.coords, m.rank, m.size) == (
            ("pod", "data", "model"), dict(pod=1, data=1, model=1),
            dict(pod=0, data=0, model=0), 0, 1)
        assert d.dp == ("pod", "data") and d.tp == "model" and d.is_coordinator
        assert (d.dp_size(), d.dp_rank(), m.device) == (1, 0, torch.device("cpu"))
        assert set(m.groups) == {("pod",), ("data",), ("model",), ("pod", "data"),
                                 ("pod", "data", "model")}
        assert m.group(("data", "pod")) is m.groups[("pod", "data")]
        x = torch.arange(4, dtype=torch.int32)
        assert torch.equal(d.psum(x, "t"), x) and torch.equal(d.all_gather(x, "t")[0], x)
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_mesh_equals_the_no_mesh_step():
    """The same loop on a forced one-rank mesh and with ``NO_DIST``: every
    param, every leaf of the train state and every metric bit for bit
    (dense AdamW; MoE with Adafactor, 2 micro-batches and compression), the
    mesh's collectives issued (one gradient reduce and one loss sum a
    step). A strided gradient keeps its layout through the reduce (the
    optimizer's global norm sums in layout order: a contiguous copy moved
    its last bit on the card)."""
    import types

    from repro_torch.core import sharding as core_sharding

    try:
        d1 = mesh_mod.make_dist(mesh_mod.train_mesh(1, 1, device="cpu"))
        G = torch.arange(12.0).reshape(4, 3)
        lin = types.SimpleNamespace(loss_fn=lambda p, b, d=None: ((p["w"].t() * G).sum(), {}))
        got = [trainer.step_grads(lin, trainer.TrainConfig(), {"w": torch.zeros(3, 4)},
                                  {"tokens": torch.zeros((8, 1), dtype=torch.int32)}, d)[2]["w"]
               for d in (pdist.NO_DIST, d1)]
        assert got[0].stride() == got[1].stride() == (1, 3) and torch.equal(got[0], got[1])
        for name in ("dense", "moe"):
            model, tcfg = C.build(name)
            spec = C.ckpt_spec(model.cfg)
            out = []
            for d in (pdist.NO_DIST, d1):
                core_sharding.reset_collective_bytes()
                p, s, data, hist = trainer.train_loop(model, tcfg, spec, 2, device="cpu", dist=d)
                out.append(({"p": p, "s": s}, hist, core_sharding.collective_calls()))
            (a, ha, calls0), (b, hb, calls1) = out
            assert calls0 == {} and calls1["grads"] == calls1["loss"] == 2, (name, calls1)
            assert ha == hb, name
            for (k, x), (_, y) in zip(tr.items(a), tr.items(b)):
                assert x.dtype == y.dtype and torch.equal(x, y), (name, k)
    finally:
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# data-parallel training: one 4-rank job, the JAX package's one-device step
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def started_job(tmp_path_factory):
    """The 4-rank job, started on a thread when the module's first test
    runs, so that it runs beside the spec tests: (directory, thread, its
    outcome)."""
    d = tmp_path_factory.mktemp("torch_dist_ranks")
    outcome = {}

    def run():
        try:
            multihost.launch_check(str(ROOT / "tests" / "torch_dist_cases.py"),
                                   marker="data-parallel cases done", num_processes=C.RANKS,
                                   args=(d,), cwd=str(ROOT), device="cpu",
                                   env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=300)
        except BaseException as e:  # re-raised by the job fixture
            outcome["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield d, thread, outcome
    thread.join(timeout=400)


@pytest.fixture(scope="module")
def job(started_job):
    """The job's output directory and every rank's record. While the job
    runs, the reference's functions are compiled and what needs no rank
    output is computed (``warm``)."""
    d, thread, outcome = started_job
    for name in C.CASES:
        warm(name)
    thread.join(timeout=400)  # launch_check kills the ranks after 300 s
    assert not thread.is_alive()
    if "error" in outcome:
        raise outcome["error"]
    return d, [json.loads((d / f"rank{r}.json").read_text()) for r in range(C.RANKS)]


def jax_model(name: str):
    c = C.case(name)
    jcfg = jconfigs.reduced(c["arch"]).replace(dtype=jnp.float32, **c["rep"])
    jtcfg = jtrainer.TrainConfig(micro_batches=c["micro"], compress_grads=c["compress"],
                                 opt=joptimizer.OptConfig(name=c["opt"], lr=C.LR,
                                                          warmup_steps=0, total_steps=10))
    return jregistry.build(jcfg), jtcfg


def sharer(name: str, keys: tuple) -> str:
    """The first case that agrees with ``name`` on ``keys``."""
    c = C.case(name)
    return next(n for n in C.CASES if all(C.case(n)[k] == c[k] for k in keys))


def reference(name: str) -> tuple:
    """The case's jitted reference functions: (params, global batch) ->
    (loss, metrics, gradients) as its step forms them; (params, train
    state, gradients as a batch) -> its step given those gradients. Cases
    of one model and train config share them."""
    return _reference(sharer(name, ("arch", "rep", "opt", "micro", "compress")))


@functools.lru_cache(maxsize=None)
def _reference(name: str) -> tuple:
    jm, jtcfg = jax_model(name)
    n = jtcfg.micro_batches
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b), has_aux=True))
    add = jax.jit(lambda acc, loss, g: (jax.tree.map(lambda a, x: a + x.astype(jnp.float32),
                                                     acc[0], g), acc[1] + loss))
    mean = jax.jit(lambda acc: (acc[1] / n, jax.tree.map(lambda a: a / n, acc[0])))

    def grads(p, batch: dict):  # a numpy batch
        if n == 1:
            (loss, mets), g = vg(p, as_jax(batch))
            return loss, mets, g
        acc = (jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
               jnp.zeros((), jnp.float32))
        micro = jtrainer._split_micro(batch, n)  # numpy: its reshapes, as the step's
        for i in range(n):
            (loss, _), g = vg(p, as_jax({k: v[i] for k, v in micro.items()}))
            acc = add(acc, loss, g)
        loss, g = mean(acc)
        return loss, {}, g

    def linear_loss(p, mb, dist=None):  # gradient mb's, in every micro-batch
        leaves = jax.tree.leaves(p)
        return sum(jnp.sum(a * mb[f"g{i}"][0]) for i, a in enumerate(leaves)), {}

    import dataclasses

    step = jtrainer.make_train_step(dataclasses.replace(jm, loss_fn=linear_loss), jtcfg)
    return grads, jax.jit(step), jtcfg


@functools.lru_cache(maxsize=None)
def init_tree(name: str) -> dict:
    """The case's params from the port's init (seed 0), as numpy."""
    return interop.cache_to_numpy(C.build(name)[0].init(seed=0, device="cpu"))


@functools.lru_cache(maxsize=None)
def first_step(name: str) -> tuple:
    """The reference's (loss, metrics, gradients) of the case's first step:
    from the init, so it needs no rank's output."""
    jgrads, _, _ = reference(name)
    return jgrads(as_jax(init_tree(name)), C.batches(C.build(name)[0].cfg, name)[0])


def warm(name: str) -> None:
    """The case's reference functions compiled (the step called once on
    zero gradients, its result dropped) and its first step computed, and a
    MoE case's reference drops."""
    _, jstep, jtcfg = reference(name)
    init = as_jax(init_tree(name))
    loss, mets, g = first_step(name)
    n = C.case(name)["micro"]
    zeros = {f"g{i}": np.zeros((n, *x.shape), x.dtype) for i, x in enumerate(jax.tree.leaves(g))}
    jax.block_until_ready(jstep(init, jtrainer.init_train_state(jtcfg, init), as_jax(zeros)))
    if C.build(name)[0].cfg.is_moe:
        reference_drops(name)


def reference_drops(name: str) -> int:
    """The reference's dropped (token, choice) pairs over the case's first
    global batch from the init; cases of one model share it."""
    return _reference_drops(sharer(name, ("arch", "rep", "micro", "masked")))


@functools.lru_cache(maxsize=None)
def _reference_drops(name: str) -> int:
    c = C.case(name)
    jcfg = jax_model(name)[0].cfg
    micro = jtrainer._split_micro(as_jax(C.batches(C.build(name)[0].cfg, name)[0]), c["micro"])
    fn = jax.jit(functools.partial(ref_drops, jcfg))
    return sum(int(fn(as_jax(init_tree(name)), {k: v[i] for k, v in micro.items()}))
               for i in range(c["micro"]))


def as_jax(tree: dict):
    return jax.tree.map(jnp.asarray, tree)


def saved_tree(npz, prefix: str) -> dict:
    paths = [k for k in npz.files if k.startswith(prefix + "/")]
    return tr.unflatten([k[len(prefix) + 1:] for k in paths], [npz[k] for k in paths])


def close(got: np.ndarray, want: np.ndarray, rtol: float, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def ref_drops(jcfg, params, mb) -> jax.Array:
    """The reference's dropped (token, choice) pairs in one forward of a
    micro-batch: its layers up to each MoE block, then ``apply_moe``'s
    route, capacity and token-major positions."""
    from repro.models import layers as jL
    from repro.models import transformer as jT

    B, S = mb["tokens"].shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    h = jT._embed_tokens(jcfg, params, mb["tokens"], pos)
    drops = jnp.zeros((), jnp.int32)
    for g in range(jcfg.n_groups):
        gp = jax.tree.map(lambda a: a[g], params["groups"])
        for j in range(jcfg.group_size):
            lp = gp[f"layer{j}"]
            h = jT._apply_mixer_train(jcfg, lp, h, pos, j, JNO_DIST)
            x = jL.apply_norm(jcfg, lp["norm2"], h)
            logits = x.reshape(B * S, -1).astype(jnp.float32) @ lp["ffn"]["router"]
            E = logits.shape[-1]
            logits = jnp.where(jnp.arange(E)[None] >= jcfg.n_experts, -jnp.inf, logits)
            experts = jax.lax.top_k(logits, jcfg.top_k)[1].reshape(-1)
            onehot = jax.nn.one_hot(experts, E, dtype=jnp.int32)
            slot = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
            T, k = B * S, jcfg.top_k
            cap = min(max(1, int(T * k / jcfg.n_experts * jcfg.capacity_factor)), T * k)
            drops = drops + (slot >= cap).sum()
            h, _ = jT._apply_ffn(jcfg, lp, h, j, JNO_DIST)
    return drops


@pytest.mark.parametrize("name", C.CASES)
def test_dp_steps_match_reference(job, name):
    """Every case at 4 ranks (and at 2 for dense and moe), 3 steps: the
    ranks bit-identical; each step's loss, gradients and update held to the
    reference's (module docstring); the collectives a step; the MoE cases
    drop exactly the reference's pairs, more than 0, where a per-rank
    capacity would differ."""
    d, records = job
    c = C.case(name)
    model, tcfg = C.build(name)
    jgrads, jstep, jtcfg = reference(name)
    cfg = model.cfg
    init = init_tree(name)
    glob = C.batches(cfg, name)
    for n in (C.RANKS, 2) if name in C.TWO_RANK else (C.RANKS,):
        recs = [r[f"{name}_n{n}"] for r in records if f"{name}_n{n}" in r]
        assert len(recs) == n and all(r["digests"] == recs[0]["digests"] for r in recs), n
        calls = recs[0]["calls"][0]
        assert calls["grads"] == calls["loss"] == 1, calls
        assert calls["ce_count"] == c["micro"] and calls.get("moe_counts", 0) == (
            2 * cfg.n_layers * c["micro"] if cfg.is_moe else 0), calls  # remat: twice
        npz = np.load(d / f"{name}_n{n}.npz")
        params, state = as_jax(init), jtrainer.init_train_state(jtcfg, as_jax(init))
        for k, b in enumerate(glob, 1):
            what = f"{name} n{n} step {k}"
            got_g = saved_tree(npz, f"step{k}/grads")
            mets = {m: float(v[0]) for m, v in saved_tree(npz, f"step{k}/mets").items()}
            loss, jmets, want_g = first_step(name) if k == 1 else jgrads(params, b)
            np.testing.assert_allclose(mets["loss"], float(loss), rtol=LOSS_RTOL, err_msg=what)
            for m, v in jmets.items():
                np.testing.assert_allclose(mets[m], float(v), rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"{what} {m}")
            got = dict(tr.items(got_g))
            want = {jpath(p): np.asarray(w)
                    for p, w in jax.tree_util.tree_flatten_with_path(want_g)[0]}
            assert set(got) == set(want), what
            for path, w in want.items():
                close(got[path], w, GRAD_RTOL, f"{what} grad {path}")
            gbatch = {f"g{i}": np.stack([g] * tcfg.micro_batches)
                      for i, g in enumerate(tr.leaves(got_g))}
            params, state, jm = jstep(params, state, as_jax(gbatch))
            got_p, got_s = saved_tree(npz, f"step{k}/params"), saved_tree(npz, f"step{k}/state")
            got = dict(tr.items({"p": got_p, "s": got_s}))
            want = jax.tree_util.tree_flatten_with_path({"p": params, "s": state})[0]
            assert set(got) == {jpath(path) for path, _ in want}, what
            for path, w in want:
                key = jpath(path)
                g = got[key]
                if "/err/" in key:
                    assert np.array_equal(g, np.asarray(w)), f"{what} {key}"
                else:
                    close(g, np.asarray(w), OPT_RTOL, f"{what} {key}")
            for m in ("lr", "grad_norm"):
                np.testing.assert_allclose(mets[m], float(jm[m]), rtol=OPT_RTOL, err_msg=what)
            params, state = as_jax(got_p), as_jax(got_s)  # the next step from the port's
        if cfg.is_moe:
            mesh_ranks = [r for i, r in enumerate(records) if f"{name}_n{n}" in r]
            tp = 2 if c["mesh"][1] == 2 and n == C.RANKS else 1
            drops = sum(r[f"{name}_n{n}"]["drops"] for r in mesh_ranks[::tp])
            want = reference_drops(name)
            T = C.B * C.S // c["micro"]
            dp = n // tp
            assert drops == want > 0, (drops, want)
            assert moe.capacity(cfg, T // dp) != moe.capacity(cfg, T), T


def test_checkpoint_of_4_ranks_resumes_on_2_and_in_one_process(job):
    """4 ranks train 4 steps with a Supervisor checkpoint every 2 (the
    coordinator writes, every rank passes the barrier); ranks 0 and 1
    restore step 2 and continue on a 2-rank mesh, and this process restores
    it and continues with no mesh: the data step is 2 again, and the losses
    of steps 3 and 4 agree with the uninterrupted run's within LOSS_RTOL."""
    d, records = job
    full = records[0]["ckpt_n4"]
    assert all(r["ckpt_n4"] == full for r in records) and full["data_step"] == 4
    assert checkpoint.latest_step(str(d / "ckpt")) == 4
    assert sorted(x for x in os.listdir(d / "ckpt") if x.startswith("step_")) == [
        "step_000000002", "step_000000004"]
    resumed = [r["ckpt_resumed_n2"] for r in records[:2]]
    assert resumed[0] == resumed[1] and "ckpt_resumed_n2" not in records[2]
    assert resumed[0]["data_step_restored"] == 2 and resumed[0]["data_step"] == 4
    model, tcfg = C.ckpt_model()
    p, s, data = C.restore(str(d / "ckpt"), model, tcfg, 2)
    assert data.step == 2
    *_, data, hist = trainer.train_loop(model, tcfg, C.ckpt_spec(model.cfg), 4, params=p,
                                        train_state=s, data_state=data)
    assert data.step == 4
    for got in (resumed[0]["losses"], [h["loss"] for h in hist]):
        np.testing.assert_allclose(got, full["losses"][2:], rtol=LOSS_RTOL)


def test_launch_train_mesh_single_in_the_job(job):
    """``launch.train --mesh single`` on a data 2 x model 2 production mesh
    (the worker sets DEFAULT_DATA / DEFAULT_MODEL to fit its 4 ranks): every
    rank returns the same finite loss, rank 0 alone logs, and its
    checkpoint at step 2 is on disk."""
    d, records = job
    runs = [r["launch"] for r in records]
    assert len({r["loss"] for r in runs}) == 1 and np.isfinite(runs[0]["loss"])
    log = runs[0]["log"]
    assert "[train] qwen2-0.5b-reduced:" in log and "[train] step     3 loss" in log
    assert "[train] done in" in log and all(r["log"] == "" for r in runs[1:])
    assert checkpoint.latest_step(str(d / "launch")) == 2


# --------------------------------------------------------------------------
# specs (last in the module: the data-parallel tests fill the job's time
# with the reference's compiles; these need no job)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
def test_param_specs_match_reference(mesh):
    """Every arch, FSDP off and at the default threshold."""
    jd, d = dists(mesh)
    for arch in configs.all_archs():
        got, want = shapes(arch)
        for fsdp in (None, sharding.FSDP_THRESHOLD):
            same_specs(sharding.param_specs(configs.get(arch), got, d, fsdp_threshold=fsdp),
                       jsharding.param_specs(jconfigs.get(arch), want, jd, fsdp_threshold=fsdp),
                       f"{mesh} {arch} fsdp={fsdp}")


def test_opt_specs_match_reference():
    """AdamW and Adafactor train states, with and without the error state,
    every arch, both meshes; the reference's path handling pinned where its
    regex misses the moments (``opt/...``) and catches the error state."""
    for mesh in MESHES:
        jd, d = dists(mesh)
        for arch in configs.all_archs():
            got, want = shapes(arch)
            cfg, jcfg = configs.get(arch), jconfigs.get(arch)
            p_specs = sharding.param_specs(cfg, got, d)
            jp_specs = jsharding.param_specs(jcfg, want, jd)
            for name in ("adamw", "adafactor"):
                states = opt_states(arch, name)
                for compress in (False, True):
                    state, jstate = ({k: v for k, v in st.items() if compress or k != "err"}
                                     for st in states)
                    specs = sharding.opt_specs(cfg, state, p_specs, d)
                    same_specs(specs, jsharding.opt_specs(jcfg, jstate, jp_specs, jd),
                               f"{mesh} {arch} {name} err={compress}")
                    if (mesh, arch, name, compress) == ("pod2-data16-model16", "qwen2-0.5b",
                                                        "adamw", True):
                        g = specs["opt"]["v"]["groups"]["layer0"]
                        assert g["norm1"]["scale"] == (None, ("pod", "data"))
                        assert specs["err"]["groups"]["layer0"]["attn"]["bk"] == \
                            (None, ("pod", "data"))
                        assert state["opt"]["v"]["groups"]["layer0"]["norm1"]["scale"].is_meta


def test_batch_and_cache_specs_match_reference():
    """Training batches (M-RoPE positions on their batch axis, Whisper's
    frames) and decode caches at B 128 (max_seq 32,768) and B 1 (1,024),
    every arch, both meshes; ``to_shardings`` pairs each spec with its mesh."""
    for mesh in MESHES:
        jd, d = dists(mesh)
        for arch in configs.all_archs():
            cfg, jcfg = configs.get(arch), jconfigs.get(arch)
            same_specs(sharding.batch_specs(registry.batch_specs(cfg, 256, 4096), d),
                       jsharding.batch_specs(jregistry.batch_specs(jcfg, 256, 4096), jd),
                       f"{mesh} {arch} batch")
            for B, max_seq in ((128, 32768), (1, 1024)):
                same_specs(sharding.cache_specs(cfg, registry.cache_specs(cfg, B, max_seq), d),
                           jsharding.cache_specs(jcfg, jregistry.cache_specs(jcfg, B, max_seq),
                                                 jd), f"{mesh} {arch} cache B={B}")
    d = dists("data4-model2")[1]
    specs = sharding.batch_specs(registry.batch_specs(configs.get("qwen2-vl-2b"), 8, 16), d)
    assert specs["positions"] == (None, ("data",), None)
    placed = sharding.to_shardings(d.mesh, specs)
    assert placed["tokens"] == pdist.NamedSharding(d.mesh, specs["tokens"])
