"""The port's moe family (reduced ``phi3.5-moe-42b-a6.6b`` and
``grok-1-314b``, softcap 30) against the JAX package on the CPU, fp32,
with the same weights carried over by ``params_from_numpy``:

- ``route``, ``_dispatch_indices`` and ``aux_load_balance_loss`` on
  identical inputs: ids, sort order, destinations and keep flags exact;
  gates, probs and the loss within 1e-6;
- ``moe_apply`` at capacity factors 1.0 and 0.5 (choices dropped; the
  reduced config itself is dropless): y and aux within 1e-4; a row's
  output does not depend on the other rows;
- the ``LM`` in train, prefill and decode modes (logits within 1e-4), the
  loss, ``moe_aux`` and every gradient against ``jax.value_and_grad``
  (loss rtol 1e-5, gradients rtol 1e-4 atol 1e-6, as
  ``tests/test_torch_train.py``);
- the int8 tree: ``init_params(int8=True)`` bitwise
  ``quantize_params(init_params(g))``; its logits against the JAX int8
  forward (1e-4);
- both engines token for token against the JAX engines on
  ``tests/test_serve_families.py``'s mix (a forced preemption, a mid-run
  admission);
- reduced ``qwen3-4b`` and ``phi3-medium-14b`` (the dense configs of this
  slice): logits and greedy tokens against the JAX ``LM``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.quant import quantize_params as jax_quantize_params
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import StaticBatchEngine as JaxStatic
from repro.train import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import reduced_config
from repro_torch.models import moe
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.train import make_loss_fn, value_and_grad
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["phi3.5-moe-42b-a6.6b", "grok-1-314b"]
# tests/test_serve_families.py's mix: two 15-token prompts whose decode
# growth crosses a page under a 4-page budget (a preemption), and a
# short third request admitted mid-run into a recycled slot
REQUESTS = [(15, 5), (15, 4), (7, 6)]
ENGINE = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4,
              page_budget=4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = LM(reduced_config(arch), device="cpu")
    return dict(arch=arch, jmodel=jmodel, jparams=jparams, model=model,
                params=params_from_numpy(tree, "cpu"))


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S))
    return toks, np.broadcast_to(np.arange(S), (B, S)).copy()


# ---------------------------------------------------------------------------
# the MoE functions
# ---------------------------------------------------------------------------
def test_route_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    router = (rng.standard_normal((64, 8)) * 0.125).astype(np.float32)
    jg, ji, jp = jax_moe.route(jnp.asarray(x), jnp.asarray(router), 2)
    g, i, p = moe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(p, i, 8)),
        float(jax_moe.aux_load_balance_loss(jp, ji, 8)), rtol=1e-6)


@pytest.mark.parametrize("capacity", [1, 3, 6, 40])
def test_dispatch_indices_match_jax(capacity):
    """Many collisions (E 4, k 2, 10 tokens a group): the stable sort, the
    left-sided starts, the slots and the drops, index for index."""
    ids = np.random.default_rng(capacity).integers(0, 4, size=(3, 10, 2))
    want = jax_moe._dispatch_indices(jnp.asarray(ids, jnp.int32), 4,
                                     capacity)
    got = moe._dispatch_indices(torch.from_numpy(ids), 4, capacity)
    for name, g, w in zip(("order", "dest", "token", "choice", "keep"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert (not got[4].all()) == (capacity < 20)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
def test_moe_apply_drops_like_jax(arch, capacity_factor):
    """At capacity factors that drop choices: y and the aux loss against
    the reference's ``moe_apply`` on the same weights and tokens."""
    jcfg = jax_reduced_config(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = reduced_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp = jax_moe.init_moe(jax.random.key(1), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((3, 16, cfg.d_model)) \
        .astype(np.float32)
    jy, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    _, ids, _ = moe.route(torch.from_numpy(x), p["router"], cfg.moe.top_k)
    keep = moe._dispatch_indices(ids, cfg.moe.num_experts,
                                 moe._capacity(16, cfg))[4]
    assert not keep.all()                     # choices were dropped
    # rows are groups: each row alone gives its own output
    for r in range(3):
        alone, _ = moe.moe_apply(p, torch.from_numpy(x[r:r + 1]), cfg)
        torch.testing.assert_close(alone[0], y[r], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
def test_moe_layers_and_tree(pair):
    params = pair["params"]
    assert sorted(params["stack"][0]) == ["attn", "ln1", "ln2", "moe"]
    m = params["stack"][0]["moe"]
    E, f = pair["model"].cfg.moe.num_experts, pair["model"].cfg.moe.expert_d_ff
    assert m["gate"].shape == (E, 128, f) and m["down"].shape == (E, f, 128)
    assert m["router"].dtype == torch.float32
    bf = LM(reduced_config(pair["arch"], param_dtype="bfloat16"),
            device="cpu").init_params(torch.Generator().manual_seed(0))
    assert bf["stack"][0]["moe"]["router"].dtype == torch.float32
    assert bf["stack"][0]["moe"]["gate"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray,
                                                 pair["jparams"])),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_train_logits_and_aux_match_jax(pair):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    toks, pos = _tokens(model.cfg, 2, 24, 1)
    jl, _, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                 jnp.asarray(pos), mode="train")
    logits, cache, aux = model.forward(params, torch.from_numpy(toks),
                                       torch.from_numpy(pos), mode="train")
    assert cache is None and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_prefill_and_decode_logits_match_jax(pair):
    """A prefill from position 0, then a ragged decode chunk (n_valid 3
    and 0) and a one-token step: logits and the K/V cache."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    B, S, L = 2, 9, 32
    toks, pos = _tokens(model.cfg, B, S, 4)
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(B, L))
    logits, cache = model.forward(params, torch.from_numpy(toks),
                                  torch.from_numpy(pos), mode="prefill",
                                  cache=model.init_cache(B, L))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    at = np.full(B, S)
    rng = np.random.default_rng(5)
    for n_valid in ([3, 0], [1, 1]):
        width = max(n_valid)
        step = rng.integers(1, model.cfg.vocab_size, size=(B, width))
        positions = at[:, None] + np.arange(width)[None]
        nv = np.asarray(n_valid, np.int32)
        jl, jc, _ = jmodel.forward(
            jparams, jnp.asarray(step, jnp.int32),
            jnp.asarray(positions, jnp.int32), mode="decode", cache=jc,
            n_valid=jnp.asarray(nv))
        logits, cache = model.forward(
            params, torch.from_numpy(step), torch.from_numpy(positions),
            mode="decode", cache=cache, n_valid=torch.from_numpy(nv))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        at = at + nv
    assert cache["pos"].tolist() == at.tolist()
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(jc["layers"][k]), **TOL)


def test_loss_aux_and_grads_match_jax(pair):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    toks, pos = _tokens(model.cfg, 2, 16, 6)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "positions": jnp.asarray(pos, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    pb = {"tokens": torch.from_numpy(toks),
          "positions": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels)}
    (jloss, jm), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jmodel), has_aux=True)(jparams, jb)
    (loss, metrics), grads = value_and_grad(make_loss_fn(model))(params, pb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(jm["moe_aux"]), rtol=1e-5)
    assert float(metrics["moe_aux"]) > 0
    want = _flat(jgrads)
    got = _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    assert any("moe/router" in k for k in want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_int8_init_is_quantize_of_init_bitwise(pair):
    model = pair["model"]
    whole = quantize_params(model.init_params(
        torch.Generator().manual_seed(3)))
    layered = model.init_params(torch.Generator().manual_seed(3), int8=True)
    a, b = _flat(params_to_numpy(whole)), _flat(params_to_numpy(layered))
    assert sorted(a) == sorted(b)
    assert "stack/moe/gate/q" in a and "stack/moe/router" in a
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key].view(np.uint8),
                                      b[key].view(np.uint8), err_msg=key)


def test_int8_logits_match_jax_int8(pair):
    """The quantized trees (the reference's bits, carried over): train
    logits, and a decode step after a prefill."""
    jmodel, jparams, model = pair["jmodel"], pair["jparams"], pair["model"]
    jq = jax_quantize_params(jparams)
    qp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert qp["stack"][0]["moe"]["up"]["q"].dtype == torch.int8
    toks, pos = _tokens(model.cfg, 2, 12, 7)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(toks), jnp.asarray(pos),
                              mode="train")
    logits, _, _ = model.forward(qp, torch.from_numpy(toks),
                                 torch.from_numpy(pos), mode="train")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    jl, jc, _ = jmodel.forward(jq, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(2, 16))
    _, cache = model.forward(qp, torch.from_numpy(toks),
                             torch.from_numpy(pos), mode="prefill",
                             cache=model.init_cache(2, 16))
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    step = np.full((2, 1), 12)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(step, jnp.int32), mode="decode",
                              cache=jc)
    logits, _ = model.forward(qp, torch.from_numpy(nxt),
                              torch.from_numpy(step), mode="decode",
                              cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def _jax_engine_tokens(jmodel, jparams, prompts, gens):
    eng = JaxEngine(jmodel, jparams, **ENGINE)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    return [np.asarray(out[r]) for r in rids]


def test_engines_match_jax_token_for_token(pair):
    """Temperature 0: the continuous engine (a preemption, a mid-run
    admission) and the static engine against the JAX continuous and
    static engines."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n)
               for n, _ in REQUESTS]
    gens = [g for _, g in REQUESTS]
    jstatic = JaxStatic(jmodel, jparams, max_len=32, batch=1)
    want = [np.asarray(jstatic.generate(jnp.asarray(p)[None], n_steps=g))[0]
            for p, g in zip(prompts, gens)]
    jcont = _jax_engine_tokens(jmodel, jparams, prompts, gens)
    eng = ContinuousBatchingEngine(model, params, **ENGINE)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    reqs = eng.requests()
    assert sum(r.n_preemptions for r in reqs) >= 1
    assert any(r.admit_step > 0 for r in reqs)
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for rid, p, g, w, jc in zip(rids, prompts, gens, want, jcont):
        np.testing.assert_array_equal(jc, w)
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(
            static.generate(p[None], n_steps=g)[0].numpy(), w)


# ---------------------------------------------------------------------------
# the dense configs of this slice
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-medium-14b"])
def test_new_dense_configs_match_jax(arch):
    """Train and prefill logits, then greedy tokens of the static engine,
    against the JAX LM and StaticBatchEngine."""
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks, pos = _tokens(model.cfg, 2, 10, 8)
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(toks), jnp.asarray(pos),
                              mode="train")
    logits, _, aux = model.forward(params, torch.from_numpy(toks),
                                   torch.from_numpy(pos), mode="train")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(pos, jnp.int32), mode="prefill",
                              cache=jmodel.init_cache(2, 32))
    logits, _ = model.forward(params, torch.from_numpy(toks),
                              torch.from_numpy(pos), mode="prefill",
                              cache=model.init_cache(2, 32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    want = np.asarray(JaxStatic(jmodel, jparams, max_len=32, batch=2)
                      .generate(jnp.asarray(toks, jnp.int32), n_steps=6))
    got = StaticBatchEngine(model, params, max_len=32, batch=2).generate(
        toks, n_steps=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_init_never_holds_the_param_dtype_tree():
    """Each layer is quantized as it is drawn: the int8 tree holds no
    weight in the param dtype apart from the norms and the fp32 router,
    and ``init_param_bytes`` is the param-dtype tree's size, reckoned
    without allocating it."""
    model = LM(reduced_config(ARCHS[0], param_dtype="bfloat16"),
               device="cpu")
    tree = model.init_params(torch.Generator().manual_seed(0), int8=True)
    big = [t for t in tree_leaves(tree)
           if t.dtype == torch.bfloat16 and t.dim() > 1]
    assert not big
    full = model.init_params(torch.Generator().manual_seed(0))
    assert model.init_param_bytes() == sum(
        t.numel() * t.element_size() for t in tree_leaves(full))
