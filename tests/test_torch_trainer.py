"""The port's training stack against the JAX package, on the CPU: the token
pipeline, the schedule, AdamW and Adafactor, int8 gradient compression,
the train step (micro-batches, compression) and loop, checkpoints and the
fault policies.

Exact where the reference is exact: the pipeline's batches, the
compression's int8 codes, float32 scales, dequantized values and error
state, the byte counts, the fault policies, a checkpoint round trip and a
restart. Float tolerances where the float32 arithmetic runs in another
order or through XLA's ``cos`` / ``pow``: OPT_RTOL for the optimizer's
leaves (the same operations, each rounded once; XLA's fused loops may
contract a multiply-add) and STEP_RTOL of each leaf's scale for a whole
train step (the loss's gradients, test_torch_train.py), its params within
UPDATE_TOL x lr besides: AdamW divides each moment by its own root, so
where a gradient is near 0 (the key bias, which the softmax all but
ignores) its float noise moves that element's update by up to about 6e-4
of lr.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import compression as jcompression  # noqa: E402
from repro.train import fault as jfault  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import checkpoint, compression, fault, optimizer, trainer  # noqa: E402
from repro_torch.train import tree as tr  # noqa: E402

OPT_RTOL, STEP_RTOL, UPDATE_TOL = 1e-5, 1e-4, 1e-3


def tiny_model():
    """The reference tests' model: reduced qwen2 in float32, vocab 64."""
    cfg = configs.reduced("qwen2-0.5b").replace(dtype=torch.float32, vocab=64)
    jcfg = jconfigs.reduced("qwen2-0.5b").replace(dtype=jnp.float32, vocab=64)
    return registry.build(cfg), jregistry.build(jcfg)


def tiny_spec(vocab=64, B=8, S=32):
    return pipeline.DataSpec(vocab=vocab, seq_len=S, global_batch=B, seed=3)


def np_flat(tree) -> dict:
    """{path: numpy} of a JAX tree or a port tree."""
    if isinstance(next(iter(tr.leaves(tree)), None), torch.Tensor):
        return {k: v.detach().view(torch.int16).numpy().view(jnp.bfloat16)
                if v.dtype == torch.bfloat16 else v.detach().numpy() for k, v in tr.items(tree)}
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close_tree(got, want, rtol: float, what: str, atol: float = 0.0) -> None:
    got, want = np_flat(got), np_flat(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), (what, k, g.dtype, w.dtype)
        if w.dtype == jnp.bfloat16:  # one bf16 rounding of the same float32 value
            g, w, tol = g.astype(np.float32), w.astype(np.float32), 2 ** -7
        else:
            tol = rtol
        np.testing.assert_allclose(g, w, rtol=tol, atol=max(atol, tol * float(np.abs(w).max())),
                                   err_msg=f"{what} {k}")


# --------------------------------------------------------------------------
# the token pipeline, the schedule, the optimizers
# --------------------------------------------------------------------------
def test_pipeline_batches_match_reference():
    """Several steps on every rank of 1, 2 and 4 data-parallel ranks, and
    through ``batches``: the reference's arrays, dtype included."""
    spec, jspec = tiny_spec(vocab=1000, B=8, S=37), jpipeline.DataSpec(vocab=1000, seq_len=37,
                                                                         global_batch=8, seed=3)
    for dp_size in (1, 2, 4):
        for rank in range(dp_size):
            st, jst = pipeline.DataState(step=5), jpipeline.DataState(step=5)
            for _ in range(3):
                (b, st), (jb, jst) = (pipeline.next_batch(spec, st, rank, dp_size),
                                      jpipeline.next_batch(jspec, jst, rank, dp_size))
                assert st.step == jst.step and set(b) == set(jb) == {"tokens", "labels"}
                for k in b:
                    assert b[k].dtype == jb[k].dtype and np.array_equal(b[k], jb[k])
    for (b, st), (jb, jst) in zip(pipeline.batches(spec, pipeline.DataState(), 3),
                                  jpipeline.batches(jspec, jpipeline.DataState(), 3)):
        assert st.step == jst.step and all(np.array_equal(b[k], jb[k]) for k in b)


def test_schedule_matches_reference():
    """Warmup, the peak and the end of the cosine, and past it (XLA's and
    torch's ``cos`` may differ in the last bit: OPT_RTOL)."""
    cfg = optimizer.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = joptimizer.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 5, 10, 11, 37, 99, 100, 120):
        got = optimizer.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = np.asarray(joptimizer.schedule(jcfg, jnp.asarray(s, jnp.int32)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL, err_msg=str(s))
    lrs = [float(optimizer.schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 100)]
    assert lrs[0] == 0.0 and abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6 and abs(lrs[3] - 0.1) < 1e-6


def opt_inputs(seed: int):
    """Params of rank 1, 2 and 3 (bf16 and float32) and three steps of
    gradients, the second large enough to clip."""
    r = np.random.default_rng(seed)
    params = {"w": r.standard_normal((6, 10)).astype(np.float32),
              "blk": {"bank": r.standard_normal((3, 4, 5)).astype(np.float32),
                      "b": r.standard_normal((7,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (r.standard_normal(p.shape) * s).astype(np.float32), params)
             for s in (0.05, 3.0, 0.2)]
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_reference(name):
    """Params (one bf16 leaf), the moments or factors, the step, lr and
    grad_norm after one step and after three, from the same numpy grads;
    the reference's update jitted, as its train step runs it."""
    params, grads = opt_inputs(1)
    cfg = optimizer.OptConfig(name=name, lr=0.05, warmup_steps=2, total_steps=10)
    jcfg = joptimizer.OptConfig(name=name, lr=0.05, warmup_steps=2, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["blk"]["bank"] = jparams["blk"]["bank"].astype(jnp.bfloat16)
    tparams = interop.params_from_numpy(params, device="cpu")
    tparams["blk"]["bank"] = tparams["blk"]["bank"].bfloat16()
    assert np.array_equal(np.asarray(jparams["blk"]["bank"], np.float32),
                          tparams["blk"]["bank"].float().numpy())
    jstate, state = joptimizer.init(jcfg, jparams), optimizer.init(cfg, tparams)
    close_tree(state, jstate, 0, "init")
    jupdate = jax.jit(lambda g, s, p: joptimizer.update(jcfg, g, s, p))
    for i, g in enumerate(grads):
        jparams, jstate, jmets = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        tparams, state, mets = optimizer.update(
            cfg, interop.params_from_numpy(g, device="cpu"), state, tparams)
        if i in (0, 2):
            close_tree(tparams, jparams, OPT_RTOL, f"params after {i + 1}")
            close_tree(state, jstate, OPT_RTOL, f"state after {i + 1}")
            for k in ("lr", "grad_norm"):
                np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=OPT_RTOL)
    assert int(state["step"]) == 3 and float(mets["grad_norm"]) > 0
    clipped, norm = optimizer.clip_by_global_norm(interop.params_from_numpy(grads[1], "cpu"), 1.0)
    jclipped, jnorm = joptimizer.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[1]), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=OPT_RTOL)
    close_tree(clipped, jclipped, OPT_RTOL, "clipped")


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------
def comp_grads():
    """Leaves of 1,000 (padded), 256 x 3 and 7 values (bf16 included), a
    zero block (scale clamped to 1e-12) and a block whose scale is exactly
    1, with halves that round to even."""
    r = np.random.default_rng(2)
    halves = np.concatenate([[127.0, -127.0], np.arange(-10, 10) + 0.5,
                             r.uniform(-126, 126, 234)]).astype(np.float32)
    return {"a": r.standard_normal(1000).astype(np.float32) * 1e-3,
            "m": np.stack([np.zeros(256, np.float32), halves,
                           r.standard_normal(256).astype(np.float32)]),
            "s": r.standard_normal(7).astype(np.float32)}


def test_compression_codes_scales_and_error_state_are_exact(monkeypatch):
    """``quantize_leaf``'s int8 codes and float32 scales, the dequantized
    gradients and the error state over three steps of error feedback, bit
    for bit against the reference as XLA compiles it (jitted, as its train
    step runs: ``/ 127.0`` a multiply by the reciprocal, the error one
    fused multiply-add); once more with leaves taken two blocks at a time.
    Halves round to even; the byte counts are the reference's."""
    grads = comp_grads()
    jquant = jax.jit(lambda x: jcompression.quantize_leaf(x)[:2])
    for g in grads.values():
        q, scale, shape, pad = compression.quantize_leaf(torch.from_numpy(g))
        jq, jscale = jquant(jnp.asarray(g))
        assert (shape, pad) == (g.shape, (-g.size) % compression.BLOCK)
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(scale.numpy(), np.asarray(jscale))
    q, _, _, _ = compression.quantize_leaf(torch.from_numpy(grads["m"][1]))
    assert q[0, 2:22].tolist() == [int(np.round(x)) for x in np.arange(-10, 10) + 0.5]  # to even
    tgrads = interop.params_from_numpy(grads, device="cpu")
    tgrads["s"] = tgrads["s"].bfloat16()
    jgrads = jax.tree.map(jnp.asarray, grads)
    jgrads["s"] = jgrads["s"].astype(jnp.bfloat16)
    compress = jax.jit(jcompression.compress_grads)
    for chunk in (compression.CHUNK, 2 * compression.BLOCK):
        monkeypatch.setattr(compression, "CHUNK", chunk)
        err, jerr = compression.init_error(tgrads), jcompression.init_error(jgrads)
        for _ in range(3):
            deq, err = compression.compress_grads(tgrads, err)
            jdeq, jerr = compress(jgrads, jerr)
            for k in grads:  # bit for bit, dtypes included
                assert np.array_equal(np_flat(deq)[k].view(np.uint8),
                                      np_flat(jdeq)[k].view(np.uint8)), (chunk, k)
                assert np.array_equal(np_flat(err)[k], np_flat(jerr)[k]), (chunk, k)
    assert compression.compressed_bytes(tgrads) == jcompression.compressed_bytes(jgrads)
    for nb in (2, 4):
        assert (compression.uncompressed_bytes(tgrads, nb)
                == jcompression.uncompressed_bytes(jgrads, nb))


# --------------------------------------------------------------------------
# the train step and loop
# --------------------------------------------------------------------------
STEP_CASES = {
    "adamw": dict(micro_batches=1, compress_grads=False, name="adamw"),
    "adafactor-micro2-compressed": dict(micro_batches=2, compress_grads=True, name="adafactor"),
}


def linear_models(model, jmodel, grads: list):
    """Both models with the loss sum(p * G_i) over the leaves, where i is
    the micro-batch's ``idx``: its gradient is G_i exactly in either
    package, so that the two train steps see the same gradients."""
    jg = [jax.tree.map(jnp.asarray, g) for g in grads]
    tg = [interop.params_from_numpy(g, device="cpu") for g in grads]

    def jloss(p, mb, dist=None):
        G = jax.tree.map(lambda *x: jnp.stack(x)[mb["idx"][0]], *jg)
        return sum(jnp.sum(a * b) for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(G))), {}

    def loss(p, mb, dist=None):
        G = tg[int(mb["idx"][0])]
        return sum(torch.sum(a * b) for a, b in zip(tr.leaves(p), tr.leaves(G))), {}

    return dataclasses.replace(model, loss_fn=loss), dataclasses.replace(jmodel, loss_fn=jloss)


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_reference(case):
    """One step from one state: from the port's init carried to JAX, the
    reference's jitted step makes a first step, its params and train state
    go to the port (``interop``), then each package takes the next step on
    the same batch.

    adamw: the model's loss and the port's own gradients; params, the
    moments and the metrics within STEP_RTOL of each leaf's scale.
    adafactor with 2 micro-batches and compression: a loss whose gradients
    are given (:func:`linear_models`; the model's are held in
    test_torch_train.py), so that accumulation, compression and Adafactor
    see the same inputs in both packages: the error state bit for bit,
    params, factors and metrics within OPT_RTOL. (Gradients that differ by
    float noise put a value within that noise of a rounding boundary on the
    neighbouring int8 code in one package: 1 of 16,384 elements of one
    leaf, with the model's loss.)"""
    kw = STEP_CASES[case]
    model, jmodel = tiny_model()
    opt = dict(name=kw["name"], lr=1e-2, warmup_steps=0, total_steps=10)
    tcfg = trainer.TrainConfig(micro_batches=kw["micro_batches"],
                               compress_grads=kw["compress_grads"],
                               opt=optimizer.OptConfig(**opt))
    jtcfg = jtrainer.TrainConfig(micro_batches=kw["micro_batches"],
                                 compress_grads=kw["compress_grads"],
                                 opt=joptimizer.OptConfig(**opt))
    jparams = jax.tree.map(jnp.asarray, interop.cache_to_numpy(model.init(seed=0, device="cpu")))
    spec = tiny_spec()
    b0, st = pipeline.next_batch(spec, pipeline.DataState())
    b1, _ = pipeline.next_batch(spec, st)
    rtol = STEP_RTOL
    if kw["compress_grads"]:
        r = np.random.default_rng(4)
        G = [jax.tree.map(lambda p: (r.standard_normal(p.shape) * 1e-2).astype(np.float32),
                          jparams) for _ in range(2)]
        model, jmodel = linear_models(model, jmodel, G)
        for b in (b0, b1):
            b["idx"] = np.repeat(np.arange(2, dtype=np.int32), spec.global_batch // 2)
        rtol = OPT_RTOL
    jstate = jtrainer.init_train_state(jtcfg, jparams)
    jstep = jax.jit(jtrainer.make_train_step(jmodel, jtcfg))
    jparams, jstate, _ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b0.items()})
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert set(np_flat(state)) == set(np_flat(trainer.init_train_state(tcfg, params)))
    close_tree(interop.train_state_to_numpy(state), jstate, 0, "carried state")
    jparams, jstate, jmets = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b1.items()})
    params, state, mets = trainer.make_train_step(model, tcfg)(
        params, state, trainer.batch_to(b1, "cpu"))
    assert set(mets) == set(jmets)
    for k in mets:
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]), rtol=rtol)
    close_tree(params, jparams, rtol, "params", atol=UPDATE_TOL * opt["lr"])
    close_tree(state["opt"], jstate["opt"], rtol, "opt")
    if kw["compress_grads"]:
        got, want = np_flat(state["err"]), np_flat(jstate["err"])
        assert all(np.array_equal(got[k], w) for k, w in want.items())
        assert any(np.abs(w).max() > 0 for w in want.values())


def test_micro_batches_and_compression_on_the_port():
    """Four micro-batches against the full batch: the same loss, nearly the
    same update (the reference tests' tolerances), no ce / aux metrics.
    The compressed step is, bit for bit, the full batch's gradients
    compressed with the error state, then the optimizer's update. The
    micro-batch split equals the reference's, M-RoPE positions included."""
    model, _ = tiny_model()
    spec = tiny_spec()
    batch = trainer.batch_to(pipeline.next_batch(spec, pipeline.DataState())[0], "cpu")
    params = model.init(seed=0, device="cpu")
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = {}
    for key, n_micro, compress in (("full", 1, False), ("micro", 4, False),
                                   ("compressed", 1, True)):
        tcfg = trainer.TrainConfig(micro_batches=n_micro, compress_grads=compress, opt=opt)
        p = tr.map(torch.clone, params)
        state = trainer.init_train_state(tcfg, p)
        p, state, mets = trainer.make_train_step(model, tcfg)(p, state, batch)
        outs[key] = (p, float(mets["loss"]), mets, state)
    assert abs(outs["full"][1] - outs["micro"][1]) < 1e-5
    assert set(outs["micro"][2]) == {"loss", "lr", "grad_norm"}  # no ce / aux, as the reference
    assert set(outs["full"][2]) == {"loss", "lr", "grad_norm", "ce", "aux"}
    for a, b in zip(tr.leaves(outs["full"][0]), tr.leaves(outs["micro"][0])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-4)
    _, _, grads = trainer._grads(model, params, batch)
    err = compression.init_error(params)
    compression.compress_grads_(grads, err)
    p = tr.map(torch.clone, params)
    p, _, _ = optimizer.update(opt, grads, optimizer.init(opt, p), p)
    assert all(torch.equal(a, b) for a, b in zip(tr.leaves(p), tr.leaves(outs["compressed"][0])))
    assert all(torch.equal(a, b) for a, b in zip(tr.leaves(err),
                                                 tr.leaves(outs["compressed"][3]["err"])))
    assert any(e.abs().max() > 0 for e in tr.leaves(err))
    r = np.random.default_rng(3)  # M-RoPE positions (3, B, S) split on their batch axis
    mb = {"tokens": r.integers(0, 9, (8, 5)).astype(np.int32),
          "positions": r.integers(0, 9, (3, 8, 5)).astype(np.int32)}
    got = trainer._split_micro(interop.params_from_numpy(mb, "cpu"), 4)
    want = jtrainer._split_micro({k: jnp.asarray(v) for k, v in mb.items()}, 4)
    assert got["positions"].shape == (4, 3, 2, 5)
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in mb)


def test_train_loop_loss_falls():
    """20 steps of the reference tests' model, plain and compressed: the
    mean loss of the last five is 0.2 below the first five's (here about
    0.63 in both)."""
    model, _ = tiny_model()
    for compress in (False, True):
        tcfg = trainer.TrainConfig(compress_grads=compress, opt=optimizer.OptConfig(
            lr=3e-3, warmup_steps=2, total_steps=20))
        *_, hist = trainer.train_loop(model, tcfg, tiny_spec(), steps=20, device="cpu")
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first - 0.2, (compress, first, last)
        assert all(np.isfinite(h["grad_norm"]) for h in hist)


# --------------------------------------------------------------------------
# checkpoints and the fault policies
# --------------------------------------------------------------------------
def test_restart_is_bit_identical(tmp_path):
    """12 steps straight against 6 steps, a Supervisor checkpoint (written
    on its thread), a restore into fresh trees and 6 more steps: every
    param and every leaf of the train state bit for bit."""
    model, _ = tiny_model()
    spec = tiny_spec()
    tcfg = trainer.TrainConfig(opt=optimizer.OptConfig(lr=1e-3, warmup_steps=0,
                                                       total_steps=30))
    p_full, ts_full, _, h_full = trainer.train_loop(model, tcfg, spec, steps=12, device="cpu")
    sup = fault.Supervisor(str(tmp_path / "ckpt"), save_every=6)
    p6, ts6, ds6, _ = trainer.train_loop(model, tcfg, spec, steps=6, supervisor=sup,
                                         device="cpu")
    assert sup.resume_step() == 6
    fresh = model.init(seed=1, device="cpu")
    like = {"params": fresh, "train_state": trainer.init_train_state(tcfg, fresh),
            "data_step": torch.tensor(0)}
    restored, manifest = checkpoint.restore(sup.ckpt_dir, like)
    assert manifest["step"] == 6 and int(restored["data_step"]) == ds6.step == 6
    for a, b in zip(tr.leaves({"p": p6, "s": ts6}),
                    tr.leaves({"p": restored["params"], "s": restored["train_state"]})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    p_res, ts_res, _, h_res = trainer.train_loop(
        model, tcfg, spec, steps=12, params=restored["params"],
        train_state=restored["train_state"],
        data_state=pipeline.DataState(step=int(restored["data_step"])))
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[6:]]
    for a, b in zip(tr.leaves({"p": p_full, "s": ts_full}), tr.leaves({"p": p_res, "s": ts_res})):
        assert torch.equal(a, b)


def test_checkpoint_layout_latest_prune_and_bf16(tmp_path):
    """The reference's layout (``step_XXXXXXXXX/`` with one .npy a leaf and
    manifest.json), ``LATEST`` moving atomically to the newest step, a
    shape mismatch rejected, ``prune`` keeping the newest, a bf16 leaf
    (NaN, inf, subnormals) round-tripped bit for bit through its uint16
    pattern, and a background save writing what the tensor held when
    ``save`` returned."""
    d = str(tmp_path / "c")
    checkpoint.save(d, 1, {"w": torch.ones(3)})
    checkpoint.save(d, 2, {"w": torch.ones(3) * 2})
    assert checkpoint.latest_step(d) == 2 and open(os.path.join(d, "LATEST")).read() == \
        "step_000000002"
    assert sorted(os.listdir(d)) == ["LATEST", "step_000000001", "step_000000002"]
    restored, _ = checkpoint.restore(d, {"w": torch.zeros(3)})
    assert torch.equal(restored["w"], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, {"w": torch.zeros(4)})
    with pytest.raises(KeyError):
        checkpoint.restore(d, {"v": torch.zeros(3)})
    for s in range(3, 6):
        checkpoint.save(d, s, {"w": torch.ones(2) * s})
    checkpoint.prune(d, keep=2)
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_000000004", "step_000000005"] and checkpoint.latest_step(d) == 5
    bits = torch.tensor([0x7FC1, 0xFF80, 0x0001, 0x8000, 0x3F80, 0xC2F7], dtype=torch.int32)
    bf = bits.to(torch.int16).view(torch.bfloat16)
    tree = {"g": {"bf": bf.clone(), "i": torch.arange(5, dtype=torch.int32)},
            "s": torch.tensor(7)}
    thread = checkpoint.save(d, 9, tree, extra={"note": "x"}, background=True)
    tree["g"]["bf"].zero_()  # after save returned: the file keeps the old bits
    thread.join()
    man = json.load(open(os.path.join(d, "step_000000009", "manifest.json")))
    assert man["leaves"]["g/bf"] == {"file": "g__bf.npy", "shape": [6], "dtype": "bfloat16"}
    assert man["extra"] == {"note": "x"} and man["step"] == 9
    back, _ = checkpoint.restore(d, tree)
    assert back["g"]["bf"].dtype == torch.bfloat16
    assert torch.equal(back["g"]["bf"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(back["g"]["i"], tree["g"]["i"]) and int(back["s"]) == 7


def test_fault_policies_match_reference():
    """``observe_step``, ``straggler_plan`` and ``surviving_mesh_shape``
    equal the reference's over seeded timings: a healthy cluster, one slow
    host, several, all slow."""
    r = np.random.default_rng(5)
    scenarios = [np.full((6, 4), 100.0), r.uniform(90, 110, (6, 4)),
                 np.tile([100.0, 100.0, 100.0, 400.0], (6, 1)),
                 r.uniform(90, 110, (8, 6)) * np.array([1, 3, 1, 1, 2.5, 1]),
                 np.full((3, 3), 500.0) * np.array([1, 1.01, 0.99])]
    for times in scenarios:
        cfg, jcfg = fault.StragglerConfig(), jfault.StragglerConfig()
        h, jh = fault.HostHealth(times.shape[1], cfg), jfault.HostHealth(times.shape[1], jcfg)
        for row in times:
            h, jh = fault.observe_step(h, row), jfault.observe_step(jh, row)
            assert np.array_equal(h.ewma_ms, jh.ewma_ms) and np.array_equal(h.misses, jh.misses)
            for micro in (1, 4, 7):
                plan, jplan = fault.straggler_plan(h, micro), jfault.straggler_plan(jh, micro)
                assert np.array_equal(plan["shares"], jplan["shares"])
                assert np.array_equal(plan["suspects"], jplan["suspects"])
    for args in ((31, 8, 16), (4, 8, 2), (2, 1, 1), (7, 4, 3)):
        assert fault.surviving_mesh_shape(*args) == jfault.surviving_mesh_shape(*args)
    with pytest.raises(RuntimeError):
        fault.surviving_mesh_shape(1, 8, 16)


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --reduced`` with
    micro-batches and compression: 3 steps with a checkpoint at step 3
    (written before it returns), then a second run to 5 steps resumes from
    it."""
    args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "4", "--micro-batches", "2", "--compress-grads",
            "--save-every", "3", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    first = launch_train.main(args + ["--steps", "3"])
    assert np.isfinite(first) and checkpoint.latest_step(str(tmp_path / "ck")) == 3
    second = launch_train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "[train] qwen2-0.5b-reduced:" in out and "[train] step     3 loss" in out
    assert "[train] resumed from step 3" in out and "[train] step     5 loss" in out
    assert np.isfinite(second)
