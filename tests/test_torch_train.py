"""The port's train stack on the CPU against the JAX package, fp32, on
reduced ``qwen3-1.7b`` and ``granite-3-2b`` (and ``mamba2-780m`` for the
ssm family's stream, loss and gradients, and launcher) with the same
weights carried over by ``params_from_numpy`` and the same batches.

- ``LM.forward(mode="train")`` logits against the JAX ``LM.forward``
  under both ``attention_impl``s (the JAX ``pallas`` impl runs its Pallas
  kernel in interpret mode) and ``remat`` none / full: 1e-4.
- the loss and every gradient of ``make_loss_fn`` against
  ``jax.value_and_grad`` (the JAX ``reference`` impl: its Pallas forward
  has no gradient) under the same ``remat`` mode, each of the four:
  loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6.
- three steps of ``make_train_step`` against the jitted JAX step with
  ``microbatches`` 1 and 2: loss, grad_norm and lr per step (rtol 1e-5)
  and every param after the third step, the decayed norm scales
  included.  Adam divides by sqrt(v), so an element whose gradient is
  near the fp32 rounding floor can take a visibly different step: every
  element must lie within 2% of the largest distance Adam can move it
  (the sum of the three lrs), and all but 0.1% of the elements within
  rtol 1e-4, atol 1e-5 (about 0.006% lie outside).
- the data stream bitwise; checkpoints written by either package read by
  the other, leaf for leaf and key for key, fp32 and bf16; a run killed
  by ``fail_at_step`` and resumed ends bit-identical to an uninterrupted
  one; the launcher's ``run`` and the parts that are not ported.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import reduced_config as jax_reduced_config
from repro.data import SyntheticLMStream as JaxStream
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import init_train_state as jax_init_train_state
from repro.train import losses as jax_losses
from repro.train import make_loss_fn as jax_make_loss_fn
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLMStream
from repro_torch.launch import train as launch_train
from repro_torch.models.model import LM
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.optim.adamw import decay_mask
from repro_torch.train import (batch_specs, init_train_state, losses,
                               make_loss_fn, make_train_step,
                               train_state_specs, value_and_grad)
from repro_torch.train.trainer import SimulatedFailure, Trainer, TrainerConfig
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 4, 32


def _flat(tree):
    """{key: numpy leaf} of a tree of arrays, keys as the checkpoints'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _jax_model(arch, **kw):
    jmodel = jax_build_model(jax_reduced_config(arch, **kw))
    return jmodel, jmodel.init_params(jax.random.key(0))


def _port(arch, jparams, **kw):
    model = LM(reduced_config(arch, **kw), device="cpu")
    return model, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _batches(cfg, n, batch=B, seq=S):
    js = JaxStream(cfg, batch, seq)
    ps = SyntheticLMStream(cfg, batch, seq, device="cpu")
    return ([js.batch_for_step(i) for i in range(n)],
            [ps.batch_for_step(i) for i in range(n)])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-2b"])
@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_logits_match_jax(arch, impl, remat):
    jmodel, jparams = _jax_model(arch, attention_impl=impl, remat=remat)
    model, params = _port(arch, jparams, attention_impl=impl, remat=remat)
    jb, pb = _batches(model.cfg, 1)
    jlogits, jcache, _ = jmodel.forward(jparams, jb[0]["tokens"],
                                        jb[0]["positions"], mode="train")
    logits, cache, aux = model.forward(params, pb[0]["tokens"],
                                       pb[0]["positions"], mode="train")
    assert cache is None and jcache is None and float(aux) == 0.0
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-2b"])
@pytest.mark.parametrize("impl,remat", [("reference", "none"),
                                        ("pallas", "none"),
                                        ("pallas", "full"),
                                        ("pallas", "save_blocks"),
                                        ("pallas", "dots")])
def test_loss_and_grads_match_jax(arch, impl, remat):
    jmodel, jparams = _jax_model(arch, remat=remat)
    model, params = _port(arch, jparams, attention_impl=impl, remat=remat)
    jb, pb = _batches(model.cfg, 1)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jmodel, z_loss=1e-4), has_aux=True)(jparams, jb[0])
    (loss, metrics), grads = value_and_grad(
        make_loss_fn(model, z_loss=1e-4))(params, pb[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), rtol=1e-6)
    want = _flat(jgrads)
    got = _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.fixture(scope="module")
def jax_three_steps():
    """The jitted JAX step, three steps from the same start, per
    microbatch count: (per-step metrics, final params)."""
    out = {}
    jmodel, jparams = _jax_model("qwen3-1.7b")
    opt = JaxAdamWConfig(lr=jax_warmup_cosine(1e-2, 2, 3))
    jb, _ = _batches(jmodel.cfg, 3)
    for mb in (1, 2):
        state = {"params": jparams,
                 "opt": jax_init_train_state(jmodel, jax.random.key(0),
                                             opt)["opt"],
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(jax_make_train_step(jmodel, opt, microbatches=mb))
        log = []
        for b in jb:
            state, metrics = step(state, b)
            log.append({k: float(metrics[k])
                        for k in ("loss", "grad_norm", "lr")})
        out[mb] = (log, _flat(state["params"]), jparams)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_three_train_steps_match_jax(jax_three_steps, microbatches, impl):
    jlog, jfinal, jparams = jax_three_steps[microbatches]
    model, params = _port("qwen3-1.7b", jparams, attention_impl=impl)
    opt = AdamWConfig(lr=warmup_cosine(1e-2, 2, 3))
    state = init_train_state(model, None, opt, params=params)
    step = make_train_step(model, opt, microbatches=microbatches)
    _, pb = _batches(model.cfg, 3)
    for want, b in zip(jlog, pb):
        state, metrics = step(state, b)
        for k in want:
            np.testing.assert_allclose(float(metrics[k]), want[k],
                                       rtol=1e-5, err_msg=k)
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    got = _flat(params_to_numpy(state["params"]))
    assert sorted(got) == sorted(jfinal)
    reach = sum(r["lr"] for r in jlog)
    outside = 0
    for key in jfinal:
        np.testing.assert_allclose(got[key], jfinal[key], rtol=0,
                                   atol=0.02 * reach, err_msg=key)
        outside += int(np.sum(np.abs(got[key] - jfinal[key])
                              > 1e-5 + 1e-4 * np.abs(jfinal[key])))
    assert outside <= 1e-3 * sum(a.size for a in jfinal.values()), outside
    # the norm scales of the layers start at 1 and are decayed as in JAX
    scale = got["stack/ln1/scale"]
    assert np.all(scale != 1.0) and np.all(got["final_norm/scale"] != 1.0)


def test_decay_mask_follows_the_reference_rank():
    model, params = _port("qwen3-1.7b", _jax_model("qwen3-1.7b")[1])
    mask = decay_mask(params)
    assert mask["embed"]["table"] and not mask["final_norm"]["scale"]
    assert all(layer["ln1"]["scale"] and layer["attn"]["q_norm"]["scale"]
               and layer["mlp"]["up"]["w"] for layer in mask["stack"])


def test_cross_entropy_and_schedule_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    got, gm = losses.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 50,
                                   mask=torch.from_numpy(mask), z_loss=1e-3)
    want, wm = jax_losses.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), 50,
                                        mask=jnp.asarray(mask), z_loss=1e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(gm["accuracy"]) == float(wm["accuracy"])
    sched, jsched = warmup_cosine(3e-4, 10, 50), jax_warmup_cosine(3e-4, 10,
                                                                   50)
    for s in (0, 1, 9, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            float(sched(torch.tensor(s, dtype=torch.int32))),
            float(jsched(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_stream_is_bitwise_the_jax_stream():
    cfg = reduced_config("qwen3-1.7b")
    jb, pb = _batches(cfg, 4, batch=3, seq=40)
    for j, p in zip(jb, pb):
        assert sorted(j) == sorted(p)
        for k in j:
            assert p[k].dtype == getattr(torch, str(j[k].dtype))
            assert tuple(p[k].shape) == j[k].shape
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_ssm_stream_is_bitwise_the_jax_stream():
    """The stream serves the ssm family the reference's plain batches."""
    cfg = reduced_config("mamba2-780m")
    jb, pb = _batches(cfg, 3, batch=2, seq=33)
    for j, p in zip(jb, pb):
        assert sorted(j) == sorted(p)
        for k in j:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))


def test_ssm_loss_and_grads_match_jax():
    """One reduced mamba2-780m batch: loss and every gradient of
    ``make_loss_fn`` against ``jax.value_and_grad`` of the JAX loss (its
    SSD the jnp ``_ssd_chunked``; the port's the plain version on the
    CPU), fp32.  Loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6, as for
    the dense family."""
    jmodel, jparams = _jax_model("mamba2-780m")
    model, params = _port("mamba2-780m", jparams)
    jb, pb = _batches(model.cfg, 1)
    (jloss, _), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jmodel, z_loss=1e-4), has_aux=True)(jparams, jb[0])
    (loss, _), grads = value_and_grad(
        make_loss_fn(model, z_loss=1e-4))(params, pb[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _flat(jgrads)
    got = _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_launcher_trains_mamba2_on_the_cpu(tmp_path):
    out = launch_train.main(["--arch", "mamba2-780m", "--reduced",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "32", "--ckpt-dir",
                             str(tmp_path)])
    losses_ = [r["loss"] for r in out["log"]]
    assert len(losses_) == 2 and np.all(np.isfinite(losses_))


def test_params_to_numpy_inverts_params_from_numpy():
    jmodel, jparams = _jax_model("qwen3-1.7b", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape
        np.testing.assert_array_equal(got[key].view(np.uint16),
                                      want[key].view(np.uint16))


def _states(dtype):
    """The same train state in both packages: the JAX state after one
    jitted step, carried into the port through numpy."""
    jmodel, _ = _jax_model("qwen3-1.7b", param_dtype=dtype)
    opt = JaxAdamWConfig(lr=1e-3)
    jstate = jax_init_train_state(jmodel, jax.random.key(0), opt)
    jb, _ = _batches(jmodel.cfg, 1)
    jstate, _ = jax.jit(jax_make_train_step(jmodel, opt))(jstate, jb[0])
    host = jax.tree.map(np.asarray, jstate)
    pstate = {"params": params_from_numpy(host["params"], "cpu"),
              "opt": {"m": params_from_numpy(host["opt"]["m"], "cpu"),
                      "v": params_from_numpy(host["opt"]["v"], "cpu"),
                      "count": torch.tensor(host["opt"]["count"])},
              "step": torch.tensor(host["step"])}
    return jstate, pstate


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _assert_same(got, want, key):
    assert got.shape == want.shape, (key, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_are_read_both_ways(tmp_path, dtype):
    jstate, pstate = _states(dtype)
    want = _flat(jstate)
    # the port writes, JAX reads
    Checkpointer(str(tmp_path / "pt")).save(1, pstate, {"loss": 1.5})
    jck = JaxCheckpointer(str(tmp_path / "pt"))
    restored, manifest = jck.restore(1, like=jstate)
    got = _flat(restored)
    assert sorted(got) == sorted(want) and manifest["metadata"] == {
        "loss": 1.5}
    for key in want:
        _assert_same(got[key], want[key], key)
    # JAX writes, the port reads
    JaxCheckpointer(str(tmp_path / "jax")).save(1, jstate)
    restored, jmanifest = Checkpointer(str(tmp_path / "jax")).restore(
        1, like=pstate)
    got = _flat({"params": params_to_numpy(restored["params"]),
                 "opt": {"m": params_to_numpy(restored["opt"]["m"]),
                         "v": params_to_numpy(restored["opt"]["v"]),
                         "count": restored["opt"]["count"].numpy()},
                 "step": restored["step"].numpy()})
    for key in want:
        _assert_same(got[key], want[key], key)
    for k in ("treedef", "leaves", "step"):
        assert manifest[k] == jmanifest[k], k
    assert isinstance(manifest["time"], float)


def _trainer(path, total=6, fail_at=None):
    cfg = reduced_config("qwen3-1.7b", attention_impl="pallas")
    model = LM(cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    return Trainer(
        make_train_step(model, opt),
        lambda: init_train_state(
            model, torch.Generator().manual_seed(0), opt),
        SyntheticLMStream(cfg, 2, 16, device="cpu"), str(path),
        TrainerConfig(total_steps=total, checkpoint_every=2,
                      fail_at_step=fail_at))


def test_trainer_kill_resume_is_bit_identical(tmp_path):
    full = _trainer(tmp_path / "a").run()
    with pytest.raises(SimulatedFailure):
        _trainer(tmp_path / "b", fail_at=5).run()
    resumed = _trainer(tmp_path / "b").run()
    assert [r["step"] for r in resumed["log"]] == [4, 5]
    assert all(r["seconds"] is None for r in full["log"])
    for a, b in ((full["state"]["params"], resumed["state"]["params"]),
                 (full["state"]["opt"]["m"], resumed["state"]["opt"]["m"]),
                 (full["state"]["opt"]["v"], resumed["state"]["opt"]["v"])):
        fa, fb = _flat(params_to_numpy(a)), _flat(params_to_numpy(b))
        for key in fa:
            _assert_same(fa[key], fb[key], key)
    assert [r["loss"] for r in full["log"][4:]] == \
        [r["loss"] for r in resumed["log"]]
    for key in ("step",):
        assert torch.equal(full["state"][key], resumed["state"][key])
    assert torch.equal(full["state"]["opt"]["count"],
                       resumed["state"]["opt"]["count"])


def test_launcher_run_trains_and_resumes(tmp_path):
    cfg = reduced_config("granite-3-2b", attention_impl="pallas")
    out = launch_train.run(cfg, steps=4, batch=2, seq=24, lr=3e-3,
                           ckpt_dir=str(tmp_path), device="cpu")
    losses_ = [r["loss"] for r in out["log"]]
    assert len(losses_) == 4 and np.all(np.isfinite(losses_))
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    again = launch_train.run(cfg, steps=5, batch=2, seq=24, lr=3e-3,
                             ckpt_dir=str(tmp_path), device="cpu")
    assert [r["step"] for r in again["log"]] == [4]
    none = launch_train.run(cfg, steps=1, batch=2, seq=24, ckpt_dir=None,
                            device="cpu")
    assert len(none["log"]) == 1


def test_unported_parts_raise():
    """The sharding specs and ``--mesh`` (ROADMAP A10) raise; fused xent,
    int8_ef and the remat modes are ported (tests/test_torch_train_extras.py,
    tests/test_torch_remat.py); a remat mode the reference lacks raises."""
    model = LM(reduced_config("qwen3-1.7b"), device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        train_state_specs(model, grad_compression="int8_ef")
    with pytest.raises(NotImplementedError, match="A10"):
        batch_specs(model.cfg)
    with pytest.raises(NotImplementedError, match="A10"):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh", "2x2"])
    bad = LM(reduced_config("qwen3-1.7b", remat="offload"), device="cpu")
    params = bad.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        bad.forward(params, torch.ones((1, 4), dtype=torch.long),
                    torch.arange(4)[None], mode="train")
