"""The port's weight-only int8 serving path (``repro_torch.models.quant``)
on the CPU against the JAX package, fp32, on reduced ``granite-3-2b``,
``qwen3-1.7b`` and ``mamba2-780m`` with the same weights carried over by
numpy.

- ``quantize_params`` of the port's per-layer tree equal bit for bit to
  the reference's ``quantize_params`` of its layer-stacked tree (int8 q and
  fp32 scale of every dense pack, Mamba projection and embedding table);
  an MoE expert leaf (E, in, out) through the MoE-key branch; the
  reference's quantized tree carried into the port and back bitwise.
- Train, prefill and decode logits of the quantized port against the
  quantized JAX ``LM``: ``rtol = atol = 1e-4`` (the port multiplies
  ``x @ (q * s)`` where the reference's unembed takes ``(x @ q) * s``,
  and the two sum in another order).
- ``tests/test_quant.py::test_quantized_model_forward_close``'s bounds on
  the port: total variation < 0.08 between the quantized and unquantized
  next-token distributions, and the quantized tree < 0.45 of the bytes.
- Both engines on the quantized tree against the JAX StaticBatchEngine on
  the quantized JAX tree: identical greedy tokens on
  ``tests/test_serve_families.py``'s request mix.
- ``launch.serve.run(int8=True)`` on the CPU, static and continuous.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.quant import quantize_params as jax_quantize_params
from repro.serve import StaticBatchEngine as JaxStatic
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.models.quant import (dequant, is_qpack, matmul_q,
                                      param_bytes, quant_dense,
                                      quantize_params)
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-3-2b", "qwen3-1.7b", "mamba2-780m"]
# tests/test_serve_families.py's mix: a preemption under a 4-page budget
# and a mid-run admission
REQUESTS = [(15, 5), (15, 4), (7, 6)]
PAGE = 8


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key].view(np.uint8),
                                      want[key].view(np.uint8), err_msg=key)


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init_params(jax.random.key(0))
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(arch=arch, jmodel=jmodel, jq=jax_quantize_params(jparams),
                model=model, params=params, qparams=quantize_params(params))


def test_quantized_tree_is_bitwise_the_jax_tree(trees):
    got = _flat(params_to_numpy(trees["qparams"]))
    want = _flat(jax.tree.map(np.asarray, trees["jq"]))
    _assert_bitwise(got, want)
    packs = [k for k in got if k.endswith("/q")]
    assert "embed/table/q" in packs
    n_dense = 6 if trees["arch"] == "mamba2-780m" else 7
    assert len(packs) == n_dense + 1


def test_qpacks_carry_through_numpy_both_ways(trees):
    """The reference's quantized tree split per layer is the port's own
    quantized tree, and restacks bitwise."""
    host = jax.tree.map(np.asarray, trees["jq"])
    carried = params_from_numpy(host, "cpu")
    layer = carried["stack"][1]
    mine = trees["qparams"]["stack"][1]
    for name in (("mamba", "wx") if "mamba" in layer else ("mlp", "up")):
        layer, mine = layer[name], mine[name]
    assert is_qpack(layer) and layer["q"].dtype == torch.int8
    assert layer["q"].dim() == 2 and layer["scale"].dim() == 1
    assert torch.equal(layer["q"], mine["q"])
    assert torch.equal(layer["scale"], mine["scale"])
    _assert_bitwise(_flat(params_to_numpy(carried)), _flat(host))


def test_moe_expert_leaves_take_the_moe_branch():
    """(E, in, out) expert weights under gate/up/down: per-(expert, out)
    scales, bitwise the reference's on its layer-stacked (L, E, in, out)
    leaves; a raw 3-d leaf under another key is left alone."""
    rng = np.random.default_rng(0)
    w = {k: rng.standard_normal((2, 3, 16, 24)).astype(np.float32)
         for k in ("gate", "up", "down")}
    other = rng.standard_normal((2, 3, 16, 24)).astype(np.float32)
    jtree = {"stack": {"moe": {**w, "other": other}}}
    want = jax.tree.map(np.asarray,
                        jax_quantize_params(jax.tree.map(jnp.asarray, jtree)))
    got = params_to_numpy(quantize_params(params_from_numpy(jtree, "cpu")))
    _assert_bitwise(_flat(got), _flat(want))
    assert got["stack"]["moe"]["gate"]["scale"].shape == (2, 3, 24)
    assert got["stack"]["moe"]["other"].dtype == np.float32
    pack = quant_dense(torch.from_numpy(w["gate"][0]))
    torch.testing.assert_close(dequant(pack, torch.float32),
                               torch.from_numpy(w["gate"][0]), atol=0.05,
                               rtol=0.02)


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S))
    return toks, np.broadcast_to(np.arange(S), (B, S)).copy()


def test_quantized_forwards_match_jax(trees):
    """Train logits; prefill logits and the cache it leaves; then one
    decode step of every row, on the quantized trees."""
    jmodel, jq, model, qp = (trees[k] for k in ("jmodel", "jq", "model",
                                                "qparams"))
    B, S = 2, 13
    toks, pos = _tokens(model.cfg, B, S, 1)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(toks), jnp.asarray(pos),
                              mode="train")
    logits, _, _ = model.forward(qp, torch.from_numpy(toks),
                                 torch.from_numpy(pos), mode="train")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    jl, jc, _ = jmodel.forward(jq, jnp.asarray(toks), jnp.asarray(pos),
                               mode="prefill", cache=jmodel.init_cache(B, 32))
    logits, cache = model.forward(qp, torch.from_numpy(toks),
                                  torch.from_numpy(pos), mode="prefill",
                                  cache=model.init_cache(B, 32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for k in cache:
        want = np.asarray(jc["layers"][k])
        got = cache[k].numpy()
        if k == "pos":
            want = want[0]
        np.testing.assert_allclose(got, want, **TOL, err_msg=k)
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    step = np.full((B, 1), S)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(nxt), jnp.asarray(step),
                              mode="decode", cache=jc)
    logits, _ = model.forward(qp, torch.from_numpy(nxt),
                              torch.from_numpy(step), mode="decode",
                              cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_quantized_forward_is_close_to_the_unquantized(trees):
    """tests/test_quant.py's bounds on the port: next-token distributions
    within total variation 0.08 on average, and < 0.45 of the bytes."""
    model, params, qp = trees["model"], trees["params"], trees["qparams"]
    cfg = model.cfg
    toks, pos = _tokens(cfg, 2, 16, 3)
    out = [model.forward(p, torch.from_numpy(toks), torch.from_numpy(pos),
                         mode="train")[0][..., :cfg.vocab_size]
           for p in (params, qp)]
    ref_p, q_p = (torch.softmax(o, -1) for o in out)
    tv = 0.5 * (ref_p - q_p).abs().sum(-1)
    assert float(tv.mean()) < 0.08, float(tv.mean())
    assert param_bytes(qp) < 0.45 * param_bytes(params)


def test_int8_engines_match_jax_static_token_for_token(trees):
    """The continuous engine (2 slots, page 8, chunk 4, a 4-page budget:
    a preemption and a mid-run admission) and the static engine on the
    quantized tree against the JAX StaticBatchEngine on the quantized JAX
    tree: identical greedy tokens."""
    jmodel, jq, model, qp = (trees[k] for k in ("jmodel", "jq", "model",
                                                "qparams"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n)
               for n, _ in REQUESTS]
    gens = [g for _, g in REQUESTS]
    jstatic = JaxStatic(jmodel, jq, max_len=32, batch=1)
    want = [np.asarray(jstatic.generate(jnp.asarray(p)[None], n_steps=g))[0]
            for p, g in zip(prompts, gens)]
    eng = ContinuousBatchingEngine(model, qp, n_slots=2, max_len=32,
                                   page_size=PAGE, prefill_chunk=4,
                                   page_budget=4)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    reqs = eng.requests()
    assert sum(r.n_preemptions for r in reqs) >= 1
    assert any(r.admit_step > 0 for r in reqs)
    static = StaticBatchEngine(model, qp, max_len=32, batch=1)
    for rid, p, g, w in zip(rids, prompts, gens, want):
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(
            static.generate(p[None], n_steps=g)[0].numpy(), w)


def test_matmul_q_flattens_leading_dims():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    pack = quant_dense(w)
    got = matmul_q(x, pack)
    assert got.shape == (2, 3, 24)
    torch.testing.assert_close(got, x @ dequant(pack, torch.float32),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(matmul_q(x, w), x @ w)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m"])
@pytest.mark.parametrize("static", [True, False])
def test_launch_serve_int8_runs_on_the_cpu(arch, static):
    res = launch_serve.run(arch, reduced=True, device="cpu", slots=2,
                           requests=3, prompt_len=12, gen_len=4,
                           prefill_chunk=4, page_size=8, static=static,
                           int8=True)
    assert res["int8"] and res["engine"] == ("static" if static
                                             else "continuous")
    assert len(res["tokens"]) == res["requests"]
    assert all(len(t) == 4 for t in res["tokens"].values())
    assert res["param_bytes"] < 0.45 * res["init_param_bytes"]
    assert res["run_ms"] is None                  # no device times here
    line = launch_serve.report(res)
    assert " int8 on cpu" in line and "-> int8" in line
