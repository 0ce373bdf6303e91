"""The rest of the port's train stack on the CPU against the JAX package,
fp32, on reduced configs with the weights carried over by
``params_from_numpy`` and the same batches:

- the vlm and audio streams (``image_embeds``, ``audio_frames``) bitwise
  the JAX stream's at steps 0 and 3;
- the loss and every gradient of ``make_loss_fn`` against
  ``jax.value_and_grad`` of the reference's for llama-3.2-vision (every
  ``gate_attn`` 0.5: at its zero init the cross path has no gradient)
  and whisper, the extras in the batch: loss rtol 1e-5, gradients rtol
  1e-4, atol 1e-6 (``tests/test_torch_train.py``'s);
- ``fused_cross_entropy`` against the JAX one in value and in both
  gradients (a padded vocab, a mask, ``vocab_chunk=32``) and against the
  plain ``cross_entropy``: 1e-5; ``make_loss_fn(fused_xent=True)``
  against the reference's for qwen3 and the vlm; audio raises in both;
- ``compress`` and ``ef_compress_tree`` bitwise the reference's on the
  same fp32 input, a layer stack quantized as one leaf; three ``int8_ef``
  steps against the jitted JAX steps: loss, grad norm and lr rtol 1e-5;
  params all but 0.1% within rtol 1e-4, atol 1e-5, and every one within
  the distance Adam can move it (the sum of the lrs), since an element
  whose gradient took the other quantum takes another step; ``grad_err``
  within one quantum everywhere (a rounding flip where the two fp32
  gradients straddle a boundary) and all but 0.1% of its elements
  within rtol 1e-4, atol 1e-5; a run killed and resumed with
  ``grad_err`` bit-identical;
- ``SSDChunked``'s backward with the plain forward standing in for the
  kernel against ``jax.grad`` of the reference's ``_ssd_chunked``, all
  six inputs, for the cotangents of y, of h_final and of both: rtol
  1e-4, atol 1e-5;
- ``launch.train`` trains reduced whisper, the vlm and jamba;
  ``repro_torch.examples.train_100m`` runs 2 steps at a tiny width.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced_config
from repro.data import SyntheticLMStream as JaxStream
from repro.models import build_model as jax_build_model
from repro.models.mamba2 import _ssd_chunked as jax_ssd_chunked
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import compression as jax_comp
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import init_train_state as jax_init_train_state
from repro.train import losses as jax_losses
from repro.train import make_loss_fn as jax_make_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLMStream
from repro_torch.examples import train_100m
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, compression, warmup_cosine
from repro_torch.train import (init_train_state, losses, make_loss_fn,
                               make_train_step, value_and_grad)
from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _gated(tree):
    """The numpy tree with every gate_attn at 0.5."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, 0.5) if k == "gate_attn" else _gated(v))
                for k, v in tree.items()}
    return tree


def _pair(arch, **kw):
    """(JAX model, JAX params, port model, port params): the same fp32
    weights, every gate_attn 0.5."""
    jmodel = jax_build_model(jax_reduced_config(arch, **kw))
    tree = _gated(jax.tree.map(np.asarray,
                               jmodel.init_params(jax.random.key(0))))
    model = LM(reduced_config(arch, **kw), device="cpu")
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            params_from_numpy(tree, "cpu"))


def _batches(cfg, n, batch=B, seq=S):
    js = JaxStream(cfg, batch, seq)
    ps = SyntheticLMStream(cfg, batch, seq, device="cpu")
    return ([js.batch_for_step(i) for i in range(n)],
            [ps.batch_for_step(i) for i in range(n)])


def _assert_grads(grads, jgrads):
    want, got = _flat(jgrads), _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the stream's extras
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,key,n", [(VLM, "image_embeds", 16),
                                        (AUDIO, "audio_frames", 24)])
def test_extras_stream_is_bitwise_the_jax_stream(arch, key, n):
    cfg = reduced_config(arch)
    js, ps = JaxStream(cfg, 3, 20), SyntheticLMStream(cfg, 3, 20,
                                                      device="cpu")
    for step in (0, 3):
        j, p = js.batch_for_step(step), ps.batch_for_step(step)
        assert sorted(j) == sorted(p) and key in p
        assert tuple(p[key].shape) == (3, n, cfg.d_model)
        for k in j:
            assert p[k].dtype == getattr(torch, str(j[k].dtype)), k
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# loss and gradients with the extras
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_loss_and_grads_with_extras_match_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    jb, pb = _batches(model.cfg, 1)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jmodel, z_loss=1e-4), has_aux=True))(jparams, jb[0])
    (loss, m), grads = value_and_grad(
        make_loss_fn(model, z_loss=1e-4))(params, pb[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6)
    _assert_grads(grads, jgrads)
    # the context reaches the loss: other extras, another loss
    other = dict(pb[0])
    key = "image_embeds" if arch == VLM else "audio_frames"
    other[key] = other[key] * 3.0
    (loss3, _), _ = value_and_grad(make_loss_fn(model))(params, other)
    assert abs(float(loss3) - float(loss)) > 1e-6


# ---------------------------------------------------------------------------
# fused cross-entropy
# ---------------------------------------------------------------------------
def test_fused_cross_entropy_matches_jax_and_the_plain_loss():
    rng = np.random.default_rng(0)
    V_pad, V, d = 100, 90, 24
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    table = (rng.standard_normal((V_pad, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)

    def jfn(x, t):
        return jax_losses.fused_cross_entropy(
            x, t, jnp.asarray(labels), V, mask=jnp.asarray(mask),
            vocab_chunk=32)[0]

    jloss, (jdx, jdt) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    xt = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    loss, metrics = losses.fused_cross_entropy(
        xt, tt, torch.from_numpy(labels), V, mask=torch.from_numpy(mask),
        vocab_chunk=32)
    dx, dt = torch.autograd.grad(loss, (xt, tt))
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["nll"].detach()) == float(loss)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=1e-5,
                               atol=1e-6)
    # the plain loss over the whole logits, value and gradients
    xp = torch.from_numpy(x).requires_grad_()
    tp = torch.from_numpy(table).requires_grad_()
    plain, _ = losses.cross_entropy(xp @ tp.t(), torch.from_numpy(labels), V,
                                    mask=torch.from_numpy(mask))
    px, pt = torch.autograd.grad(plain, (xp, tp))
    np.testing.assert_allclose(float(loss), float(plain.detach()), rtol=1e-5)
    np.testing.assert_allclose(dx.numpy(), px.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), pt.numpy(), rtol=1e-5, atol=1e-6)
    # the padded rows get no gradient
    assert not dt[V:].any()


def test_fused_lse_backward_holds_one_chunk_at_a_time():
    """The backward's largest saved or live tensor is a chunk's logits:
    the Function saves x, the table and lse, never a (B, S, V) tensor."""
    x = torch.randn(2, 8, 16, requires_grad=True)
    table = torch.randn(200, 16, requires_grad=True)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lse = losses.ChunkedLogSumExp.apply(x, table, 190, 32)
    assert (2, 8, 200) not in saved and all(s[-1] != 200 for s in saved)
    lse.sum().backward()
    want = torch.logsumexp(x.detach() @ table.detach()[:190].t(), -1)
    torch.testing.assert_close(lse.detach(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", VLM])
def test_fused_loss_fn_matches_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    jb, pb = _batches(model.cfg, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jmodel, fused_xent=True), has_aux=True))(
            jparams, jb[0])
    (loss, metrics), grads = value_and_grad(
        make_loss_fn(model, fused_xent=True))(params, pb[0])
    assert sorted(metrics) == ["loss", "nll"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_grads(grads, jgrads)
    (plain, _), _ = value_and_grad(make_loss_fn(model))(params, pb[0])
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)


def test_fused_loss_fn_raises_for_the_enc_dec_as_the_reference():
    jmodel, jparams, model, params = _pair(AUDIO)
    jb, pb = _batches(model.cfg, 1)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        jax_make_loss_fn(jmodel, fused_xent=True)(jparams, jb[0])
    with pytest.raises(NotImplementedError, match="enc-dec"):
        make_loss_fn(model, fused_xent=True)(params, pb[0])


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-3, 1.0, 0.0])
def test_compress_is_bitwise_the_reference(scale):
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((37, 65)) * scale).astype(np.float32)
    g[0, :3] = [127.5 * scale, -0.5 * scale, 2.5 * scale]   # ties
    q, s = compression.compress(torch.from_numpy(g))
    jq, js = jax_comp.compress(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(compression.decompress(q, s).numpy(),
                                  np.asarray(jax_comp.decompress(jq, js)))


def test_ef_compress_tree_is_bitwise_the_reference():
    rng = np.random.default_rng(2)
    f = np.float32

    def tree(scale):
        # a layer stack of 3 whose layers differ in scale by 100x: the
        # reference quantizes the (3, ...) leaf with one scale
        return {"a": (rng.standard_normal((8, 9)) * scale).astype(f),
                "stack": {"w": (rng.standard_normal((3, 5, 4)) * scale
                                * np.array([1, 100, 1e-2])[:, None, None]
                                ).astype(f),
                          "n": {"s": (rng.standard_normal((3, 7))
                                      * scale).astype(f)}}}

    grads, err = tree(1.0), tree(1e-3)
    jdeq, jerr = jax_comp.ef_compress_tree(jax.tree.map(jnp.asarray, grads),
                                           jax.tree.map(jnp.asarray, err))

    def port(t):
        """The port's tree: the stack as a list of per-layer dicts."""
        st = t["stack"]
        return {"a": torch.from_numpy(t["a"].copy()), "stack": [
            {"w": torch.from_numpy(st["w"][i].copy()),
             "n": {"s": torch.from_numpy(st["n"]["s"][i].copy())}}
            for i in range(3)]}

    terr = port(err)
    deq, new_err = compression.ef_compress_tree(port(grads), terr)
    assert new_err is terr                      # the residual, in place
    for got, want in ((deq, jdeq), (new_err, jerr)):
        got, want = _flat(params_to_numpy(got)), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    zero = compression.init_error_state(
        {"w": torch.ones(3, 4, dtype=torch.bfloat16)})
    assert zero["w"].dtype == torch.float32 and not zero["w"].any()


def test_int8_ef_three_steps_match_jax():
    jmodel, jparams, model, params = _pair("qwen3-1.7b")
    jopt = JaxAdamWConfig(lr=jax_warmup_cosine(1e-2, 2, 3))
    jstate = jax_init_train_state(jmodel, jax.random.key(0), jopt,
                                  grad_compression="int8_ef")
    jstate["params"] = jparams
    jstep = jax.jit(jax_make_train_step(jmodel, jopt,
                                        grad_compression="int8_ef"))
    opt = AdamWConfig(lr=warmup_cosine(1e-2, 2, 3))
    state = init_train_state(model, None, opt, "int8_ef", params=params)
    assert sorted(state) == ["grad_err", "opt", "params", "step"]
    step = make_train_step(model, opt, grad_compression="int8_ef")
    jb, pb = _batches(model.cfg, 3, batch=4, seq=32)
    reach = 0.0
    for j, p in zip(jb, pb):
        jstate, jm = jstep(jstate, j)
        state, m = step(state, p)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        reach += float(jm["lr"])
    got = _flat(params_to_numpy(state["params"]))
    jfinal = _flat(jstate["params"])
    outside = 0
    for key, want in jfinal.items():
        # an element whose gradient took the other quantum takes another
        # Adam step: it stays within the distance Adam can move it
        np.testing.assert_allclose(got[key], want, rtol=0, atol=reach,
                                   err_msg=key)
        outside += int(np.sum(np.abs(got[key] - want)
                              > 1e-5 + 1e-4 * np.abs(want)))
    assert outside <= 1e-3 * sum(a.size for a in jfinal.values()), outside
    # a residual element differs by one quantum where the two fp32
    # gradients straddle a rounding boundary (|err| <= quantum / 2)
    got = _flat(params_to_numpy(state["grad_err"]))
    jerr = _flat(jstate["grad_err"])
    assert sorted(got) == sorted(jerr)
    outside = 0
    for key, want in jerr.items():
        np.testing.assert_allclose(got[key], want, rtol=0,
                                   atol=1.01 * 2 * np.abs(want).max() + 1e-9,
                                   err_msg=key)
        outside += int(np.sum(np.abs(got[key] - want)
                              > 1e-5 + 1e-4 * np.abs(want)))
    assert outside <= 1e-3 * sum(a.size for a in jerr.values()), outside


def _ef_trainer(path, total=4, fail_at=None):
    cfg = reduced_config("qwen3-1.7b")
    model = LM(cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    return Trainer(
        make_train_step(model, opt, grad_compression="int8_ef"),
        lambda: init_train_state(model, torch.Generator().manual_seed(0),
                                 opt, "int8_ef"),
        SyntheticLMStream(cfg, 2, 16, device="cpu"), str(path),
        TrainerConfig(total_steps=total, checkpoint_every=2,
                      fail_at_step=fail_at))


def test_int8_ef_kill_resume_is_bit_identical(tmp_path):
    full = _ef_trainer(tmp_path / "a").run()
    with pytest.raises(SimulatedFailure):
        _ef_trainer(tmp_path / "b", fail_at=3).run()
    _, manifest = Checkpointer(str(tmp_path / "b")).restore(2)
    assert any(leaf["key"].startswith("grad_err/")
               for leaf in manifest["leaves"])
    resumed = _ef_trainer(tmp_path / "b").run()
    assert [r["step"] for r in resumed["log"]] == [2, 3]
    a, b = tree_leaves(full["state"]), tree_leaves(resumed["state"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tree_leaves(full["state"]["grad_err"])[0].abs().sum() > 0


# ---------------------------------------------------------------------------
# the SSD Function's backward
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, b=2, S=40, h=3, P=16, N=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    sp = np.log1p(np.exp(rng.standard_normal((b, S, h))))
    return dict(x=rng.standard_normal((b, S, h, P)).astype(f),
                dt=(sp * 0.1).astype(f),
                A=(-np.exp(rng.standard_normal(h))).astype(f),
                B=(rng.standard_normal((b, S, N)) * 0.5).astype(f),
                C=(rng.standard_normal((b, S, N)) * 0.5).astype(f),
                D=rng.standard_normal(h).astype(f))


@pytest.mark.parametrize("cot", ["y", "h", "both"])
def test_ssd_function_backward_matches_jax_grad(cot):
    d = _ssd_inputs(3)
    rng = np.random.default_rng(4)
    gy = rng.standard_normal(d["x"].shape).astype(np.float32)
    gh = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    wy, wh = {"y": (1, 0), "h": (0, 1), "both": (1, 1)}[cot]
    names = ("x", "dt", "A", "B", "C", "D")

    def jloss(*args):
        y, h = jax_ssd_chunked(*args, chunk=16)
        return wy * jnp.sum(y * gy) + wh * jnp.sum(h * gh)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *(jnp.asarray(d[k]) for k in names))
    ts = [torch.from_numpy(d[k]).requires_grad_() for k in names]
    y, h = ssd_ops.SSDChunked.apply(ssd_ref.ssd_chunked, *ts, 16)
    outs, cots = [], []
    if wy:
        outs.append(y)
        cots.append(torch.from_numpy(gy))
    if wh:
        outs.append(h)
        cots.append(torch.from_numpy(gh))
    got = torch.autograd.grad(outs, ts, cots, materialize_grads=True)
    for k, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_ssd_function_grads_only_what_needs_them():
    d = _ssd_inputs(5)
    ts = {k: torch.from_numpy(v) for k, v in d.items()}
    ts["x"].requires_grad_()
    y, h = ssd_ops.SSDChunked.apply(ssd_ref.ssd_chunked, *ts.values(), 16)
    (gx,) = torch.autograd.grad(y.sum(), [ts["x"]])
    live = ts["x"].detach().requires_grad_()
    want_y, _ = ssd_ref.ssd_chunked(live, *list(ts.values())[1:], 16)
    (want,) = torch.autograd.grad(want_y.sum(), [live])
    torch.testing.assert_close(gx, want)
    assert h.requires_grad and ts["A"].grad is None


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [AUDIO, VLM, "jamba-v0.1-52b"])
def test_launcher_trains_every_family_on_the_cpu(tmp_path, arch):
    out = launch_train.run(reduced_config(arch), steps=2, batch=2, seq=16,
                           ckpt_dir=str(tmp_path), device="cpu")
    losses_ = [r["loss"] for r in out["log"]]
    assert len(losses_) == 2 and np.all(np.isfinite(losses_))
    assert Checkpointer(str(tmp_path)).all_steps() == [1, 2]


def test_train_100m_example_runs_two_steps(tmp_path, capsys, monkeypatch):
    full = train_100m.config()
    assert (full.n_layers, full.d_model, full.head_dim, full.d_ff,
            full.vocab_size) == (12, 512, 64, 2048, 50_304)
    monkeypatch.setattr(train_100m, "config", lambda: dataclasses.replace(
        full, n_layers=2, d_model=64, head_dim=8, d_ff=256, vocab_size=512))
    out = train_100m.main(["--device", "cpu", "--steps", "2", "--batch",
                           "2", "--seq", "16", "--ckpt-dir",
                           str(tmp_path)])
    assert [r["step"] for r in out["log"]] == [0, 1]
    assert np.all(np.isfinite([r["loss"] for r in out["log"]]))
    assert (tmp_path / "metrics.json").exists()
    assert "training" in capsys.readouterr().out
