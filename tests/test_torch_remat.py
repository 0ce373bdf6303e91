"""The port's four remat modes (``blocks.REMAT_MODES``: none, full,
save_blocks, dots) on the CPU, fp32, reduced configs, the weights
carried over from the JAX package's ``init_params`` by
``params_from_numpy`` (every ``gate_attn`` 0.5, so the vlm's cross path
has a gradient):

- for the ssm, moe, vlm and audio families, the loss and every gradient
  of ``make_loss_fn`` under each mode against ``jax.value_and_grad`` of
  the reference's (without remat: ``jax.checkpoint`` recomputes the same
  ops; the dense family is held against the JAX model under the same
  mode in ``tests/test_torch_train.py``): loss rtol 1e-5, gradients rtol
  1e-4, atol 1e-6; and the port's modes against each other, the hybrid
  family too: the same loss, gradients rtol 1e-5, atol 1e-7;
- what each mode keeps: ``full`` checkpoints each layer, ``save_blocks``
  each block (a dense layer's attention and FFN), ``dots`` each layer
  under the selective policy; in the backward ``full`` and
  ``save_blocks`` run the layers' matrix products again, ``dots`` none
  of them, as ``none``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced_config
from repro.data import SyntheticLMStream as JaxStream
from repro.models import build_model as jax_build_model
from repro.train import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLMStream
from repro_torch.models import blocks
from repro_torch.models.model import LM
from repro_torch.train import make_loss_fn, value_and_grad
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

MODES = blocks.REMAT_MODES
FAMILIES = ["mamba2-780m", "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-90b",
            "whisper-base"]
B, S = 2, 16
_CHECKPOINT = blocks.checkpoint


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _gated(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, 0.5) if k == "gate_attn" else _gated(v))
                for k, v in tree.items()}
    return tree


def _port_grads(arch, mode, params):
    """(loss, flat grads) of the port's ``make_loss_fn`` under ``mode`` on
    the stream's step-0 batch."""
    model = LM(reduced_config(arch, remat=mode), device="cpu")
    batch = SyntheticLMStream(model.cfg, B, S, device="cpu").batch_for_step(0)
    (loss, _), grads = value_and_grad(make_loss_fn(model))(params, batch)
    return float(loss), _flat(params_to_numpy(grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_grads_under_every_mode_match_jax(arch):
    """The JAX gradient is computed once, without remat (jax.checkpoint
    recomputes the same ops, so its gradients are those of every mode);
    each of the port's modes is held against it."""
    jmodel = jax_build_model(jax_reduced_config(arch))
    tree = _gated(jax.tree.map(np.asarray,
                               jmodel.init_params(jax.random.key(0))))
    batch = JaxStream(jmodel.cfg, B, S).batch_for_step(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jmodel), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), batch)
    want = _flat(jgrads)
    for mode in MODES:
        loss, got = _port_grads(arch, mode, params_from_numpy(tree, "cpu"))
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5,
                                   err_msg=mode)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{mode} {key}")


@pytest.mark.parametrize("arch", FAMILIES + ["jamba-v0.1-52b"])
def test_modes_give_the_same_grads(arch):
    model = LM(reduced_config(arch), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    for p in _gates(params):
        p.fill_(0.5)
    loss0, base = _port_grads(arch, "none", params)
    for mode in MODES[1:]:
        loss, got = _port_grads(arch, mode, params)
        assert loss == loss0, mode
        for key in base:
            np.testing.assert_allclose(got[key], base[key], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{mode} {key}")


def _gates(tree):
    """Every ``gate_attn`` tensor of a port tree."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in ([v] if k == "gate_attn" else _gates(v))]
    if isinstance(tree, list):
        return [t for x in tree for t in _gates(x)]
    return []


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in blocks.DOT_OPS
        return func(*args, **(kwargs or {}))


def _checkpoints_and_matmuls(monkeypatch, mode):
    """(checkpoint calls in the forward, matrix products in the forward,
    matrix products in the backward) of a reduced dense loss."""
    calls = []

    def counted(fn, *args, **kw):
        calls.append(kw.get("context_fn") is not None)
        return _CHECKPOINT(fn, *args, **kw)

    monkeypatch.setattr(blocks, "checkpoint", counted)
    model = LM(reduced_config("qwen3-1.7b", remat=mode), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    batch = SyntheticLMStream(model.cfg, B, S, device="cpu").batch_for_step(0)
    with _CountMatmuls() as fwd:
        loss, _ = make_loss_fn(model)(params, batch)
    with _CountMatmuls() as bwd:
        torch.autograd.grad(loss, leaves)
    return calls, fwd.n, bwd.n


def test_what_each_mode_keeps(monkeypatch):
    n_layers = reduced_config("qwen3-1.7b").n_layers
    got = {m: _checkpoints_and_matmuls(monkeypatch, m) for m in MODES}
    assert got["none"][0] == []
    assert got["full"][0] == [False] * n_layers
    assert got["save_blocks"][0] == [False] * (2 * n_layers)
    assert got["dots"][0] == [True] * n_layers
    fwd = got["none"][1]
    assert all(g[1] == fwd for g in got.values())
    # the layers' products run again in the backward of full and
    # save_blocks (not the unembedding's, outside any layer; the
    # recompute stops once the last saved tensor is rebuilt); dots keeps
    # them, so its backward runs exactly none's products
    bwd = got["none"][2]
    assert got["dots"][2] == bwd
    for mode in ("full", "save_blocks"):
        assert bwd < got[mode][2] < bwd + fwd, mode
