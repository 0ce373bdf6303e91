"""The port's hybrid family (reduced ``jamba-v0.1-52b``: one period of 8
layers, attention at offset 4, MoE on the odd layers, no RoPE) against
the JAX package on the CPU, fp32, with the same weights carried over by
``params_from_numpy``:

- ``blocks.mamba_layer`` with an MLP and with an MoE FFN in train,
  prefill and decode (ragged ``n_valid``) modes: y, state and aux within
  1e-4;
- the ``LM`` in train, prefill and decode modes: logits, aux, and the
  state (attention K/V and ``pos``, each mamba sub-layer's ``h`` and
  ``conv``) within 1e-4; a row with ``n_valid`` 0 keeps its state bit
  for bit; the loss, ``moe_aux`` and every gradient against
  ``jax.value_and_grad`` (as ``tests/test_torch_moe.py``), and
  ``remat="full"`` (each sub-layer checkpointed) giving the same;
- the period-stacked ``s0``…``s7`` tree through the weight bridge both
  ways, bit for bit; ``init_params(int8=True)`` bitwise
  ``quantize_params(init_params(g))``; the int8 logits against the JAX
  int8 forward; ``init_param_bytes`` of the full config against the
  reference tree's bytes (``jax.eval_shape``);
- both engines (``paged_kernel`` True and False) and the static engine
  token for token against the JAX ``StaticBatchEngine`` on
  ``tests/test_serve_families.py``'s mix (a forced preemption, a mid-run
  admission); ``prefix_cache=True`` warns and serves;
- ``launch.serve.run`` (static, continuous, int8) and ``launch.train.run``
  on the CPU; a depth that is not a whole number of periods is refused;
  RoPE tables are never computed at ``rope_theta`` 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.models.quant import quantize_params as jax_quantize_params
from repro.serve import StaticBatchEngine as JaxStatic
from repro.train import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import blocks, layers
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.train import make_loss_fn, value_and_grad
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-v0.1-52b"
# tests/test_serve_families.py's mix: two 15-token prompts whose decode
# growth crosses a page under a 4-page budget (a preemption), and a
# short third request admitted mid-run into a recycled slot
REQUESTS = [(15, 5), (15, 4), (7, 6)]
ENGINE = dict(n_slots=2, max_len=32, page_size=8, prefill_chunk=4,
              page_budget=4)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(jax_reduced_config(ARCH))
    jparams = jmodel.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = LM(reduced_config(ARCH), device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, tree=tree, model=model,
                params=params_from_numpy(tree, "cpu"))


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S))
    return toks, np.broadcast_to(np.arange(S), (B, S)).copy()


def _jax_state(jc):
    """The reference's {"periods": {"attn", "ssm"}} cache in the port's
    layout: ``pos`` one counter a slot, the recurrent state flattened to
    one entry a mamba sub-layer, period-major."""
    per = jc["periods"]
    out = {"attn": {k: np.asarray(per["attn"][k]) for k in ("k", "v")},
           "ssm": {k: np.asarray(v).reshape((-1,) + v.shape[2:])
                   for k, v in per["ssm"].items()}}
    out["attn"]["pos"] = np.asarray(per["attn"]["pos"])[0]
    return out


def _assert_state(cache, jc):
    want = _jax_state(jc)
    np.testing.assert_array_equal(cache["attn"]["pos"].numpy(),
                                  want["attn"]["pos"])
    for group, keys in (("attn", ("k", "v")), ("ssm", ("h", "conv"))):
        for k in keys:
            np.testing.assert_allclose(cache[group][k].numpy(),
                                       want[group][k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# the mamba layer with an FFN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("sub,ffn", [("s0", "mlp"), ("s1", "moe")])
def test_mamba_layer_with_ffn_matches_jax(pair, sub, ffn, mode):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    cfg = model.cfg
    p = params["stack"][0][sub]
    assert sorted(p) == sorted(["ln1", "mamba", "ln2", ffn])
    jp = jax.tree.map(lambda a: a[0], jparams["stack"][sub])
    rng = np.random.default_rng(1)
    B, S = 3, 21
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    jstate = state = nv = None
    if mode == "decode":
        jstate = jax.tree.map(lambda a: a[0, 0],
                              jmodel.init_cache(B, 8)["periods"]["ssm"])
        jstate = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.1,
                                 v.dtype) for k, v in jstate.items()}
        state = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
        nv = np.array([S, 4, 0], np.int32)
    jy, jst, jaux = jax_blocks.mamba_layer(
        jp, jnp.asarray(x), jmodel.cfg, mode=mode, state=jstate,
        n_valid=None if nv is None else jnp.asarray(nv))
    before = None if state is None else {k: v.clone()
                                         for k, v in state.items()}
    y, st, aux = blocks.mamba_layer(
        p, torch.from_numpy(x), cfg, mode=mode, state=state,
        n_valid=None if nv is None else torch.from_numpy(nv))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    if mode == "train":
        assert st is None
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        assert (float(aux) > 0) == (ffn == "moe")
        return
    assert aux is None
    got = state if mode == "decode" else st
    for k in ("h", "conv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jst[k]), **TOL)
    if mode == "decode":                    # row 2: n_valid 0
        for k in ("h", "conv"):
            assert torch.equal(state[k][2], before[k][2])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
def test_weights_carry_the_period_tree_both_ways(pair):
    """One stack entry a period, its sub-layers s0…s7 (attention at s4,
    MoE on s1, s3, s5, s7); the tree restacks to the reference's bit for
    bit, and a bf16 tree comes back unchanged."""
    params, tree = pair["params"], pair["tree"]
    assert len(params["stack"]) == 1
    period = params["stack"][0]
    assert sorted(period) == [f"s{j}" for j in range(8)]
    assert "attn" in period["s4"] and "mlp" in period["s4"]
    for j in (0, 2, 6):
        assert "mamba" in period[f"s{j}"] and "mlp" in period[f"s{j}"]
    for j in (1, 3, 5, 7):
        assert "mamba" in period[f"s{j}"] and "moe" in period[f"s{j}"]
    back = params_to_numpy(params)
    a, b = _flat(tree), _flat(back)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    bf = LM(reduced_config(ARCH, param_dtype="bfloat16"), device="cpu")
    p = bf.init_params(torch.Generator().manual_seed(0))
    again = params_from_numpy(params_to_numpy(p), "cpu")
    for x, y in zip(tree_leaves(p), tree_leaves(again)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_logits_and_aux_match_jax(pair):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    toks, pos = _tokens(model.cfg, 2, 37, 1)
    jl, _, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                 jnp.asarray(pos), mode="train")
    logits, cache, aux = model.forward(params, torch.from_numpy(toks),
                                       torch.from_numpy(pos), mode="train")
    assert cache is None and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


def test_prefill_state_and_ragged_decode_match_jax(pair):
    """A prefill from position 0 (S 21 over chunks of 16) and the state it
    leaves; then a ragged chunk (n_valid 3, 0, 2) and one-token steps:
    logits of the valid columns and the whole state, the n_valid-0 row's
    recurrent state and K/V kept bit for bit."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    B, S, L = 3, 21, 40
    toks, pos = _tokens(model.cfg, B, S, 4)
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(B, L))
    logits, cache = model.forward(params, torch.from_numpy(toks),
                                  torch.from_numpy(pos), mode="prefill",
                                  cache=model.init_cache(B, L))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_state(cache, jc)
    at = np.full(B, S)
    rng = np.random.default_rng(5)
    for n_valid in ([3, 0, 2], [1, 1, 1], [0, 1, 1]):
        width = max(n_valid)
        step = rng.integers(1, model.cfg.vocab_size, size=(B, width))
        positions = at[:, None] + np.arange(width)[None]
        nv = np.asarray(n_valid, np.int32)
        before = params_to_numpy(cache)
        jl, jc, _ = jmodel.forward(
            jparams, jnp.asarray(step, jnp.int32),
            jnp.asarray(positions, jnp.int32), mode="decode", cache=jc,
            n_valid=jnp.asarray(nv))
        logits, cache = model.forward(
            params, torch.from_numpy(step), torch.from_numpy(positions),
            mode="decode", cache=cache, n_valid=torch.from_numpy(nv))
        for r, n in enumerate(n_valid):
            np.testing.assert_allclose(logits[r, :n].numpy(),
                                       np.asarray(jl)[r, :n], **TOL)
            if n == 0:
                now = params_to_numpy(cache)
                for group, keys in (("attn", ("k", "v")),
                                    ("ssm", ("h", "conv"))):
                    for k in keys:
                        np.testing.assert_array_equal(
                            now[group][k][:, r], before[group][k][:, r])
        _assert_state(cache, jc)
        at = at + nv
    assert cache["attn"]["pos"].tolist() == at.tolist()


def test_loss_aux_and_grads_match_jax(pair):
    """The train loss (cross entropy + 0.01 x the 4 MoE sub-layers' aux),
    ``moe_aux`` and every gradient against ``jax.value_and_grad`` of the
    reference's loss (its ``_ssd_chunked`` path)."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    toks, pos = _tokens(model.cfg, 2, 24, 6)
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
    want = _flat(jgrads)
    got = _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    assert "stack/s1/moe/router" in want and "stack/s4/attn/wq/w" in want
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_remat_full_checkpoints_each_sublayer(pair, monkeypatch):
    """``remat="full"``: each of the period's 8 sub-layers runs under
    ``torch.utils.checkpoint`` (its forward again in the backward); the
    loss and every gradient equal those without remat."""
    model, params = pair["model"], pair["params"]
    remat = LM(reduced_config(ARCH, remat="full"), device="cpu")
    toks, pos = _tokens(model.cfg, 2, 16, 7)
    batch = {"tokens": torch.from_numpy(toks),
             "positions": torch.from_numpy(pos),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    calls = []
    wrapped = blocks.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.func.__name__)
        return wrapped(fn, *args, **kw)

    monkeypatch.setattr(blocks, "checkpoint", counting)
    (l1, m1), g1 = value_and_grad(make_loss_fn(remat))(params, batch)
    assert calls == ["_mamba_step"] * 4 + ["attn_layer"] + \
        ["_mamba_step"] * 3
    (l0, m0), g0 = value_and_grad(make_loss_fn(model))(params, batch)
    assert len(calls) == 8
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    torch.testing.assert_close(m1["moe_aux"], m0["moe_aux"], rtol=1e-6,
                               atol=0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_int8_init_is_quantize_of_init_bitwise(pair):
    """Each sub-layer is quantized as it is drawn: the same bits as the
    whole tree quantized after the draw."""
    model = pair["model"]
    whole = quantize_params(model.init_params(
        torch.Generator().manual_seed(3)))
    layered = model.init_params(torch.Generator().manual_seed(3), int8=True)
    a, b = _flat(params_to_numpy(whole)), _flat(params_to_numpy(layered))
    assert sorted(a) == sorted(b)
    for key in ("stack/s1/moe/gate/q", "stack/s0/mamba/wB/q",
                "stack/s4/attn/wq/q", "stack/s2/mlp/up/scale"):
        assert key in a, key
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
    assert qp["stack"][0]["s3"]["moe"]["up"]["q"].dtype == torch.int8
    assert qp["stack"][0]["s3"]["mamba"]["wdt"]["q"].dtype == torch.int8
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


def test_init_param_bytes_match_the_reference_tree():
    """The full config's tree in bf16, reckoned on the meta device, has
    the bytes of the reference's ``init_params`` tree (``jax.eval_shape``:
    fp32 A_log, D, dt_bias and routers included), ~103 GB; one period is
    8 sub-layers, 4 of them MoE."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    want = sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(shapes))
    model = LM(get_config(ARCH), device="cpu")
    assert model.n_periods == 4
    assert model.init_param_bytes() == want
    assert 100e9 < want < 106e9


def test_int8_init_never_holds_the_param_dtype_tree():
    model = LM(reduced_config(ARCH, param_dtype="bfloat16"), device="cpu")
    tree = model.init_params(torch.Generator().manual_seed(0), int8=True)
    big = [t for t in tree_leaves(tree)
           if t.dtype == torch.bfloat16 and t.dim() > 1]
    # the conv taps (k, conv_dim) are the only 2-d bf16 leaves left
    assert len(big) == 7 and all(t.shape[0] == 4 for t in big)


def test_lm_refuses_a_depth_off_the_period():
    with pytest.raises(ValueError, match="attn_period"):
        LM(reduced_config(ARCH, n_layers=12), device="cpu")
    with pytest.raises(ValueError, match="attn_period"):
        launch_serve.run(ARCH, reduced=True, layers=12, device="cpu")
    assert LM(reduced_config(ARCH, n_layers=16), device="cpu").n_periods == 2


def test_no_rope_tables_at_theta_zero(pair, monkeypatch):
    """jamba has no RoPE (theta 0, where 1/theta^e is inf and the tables
    NaN): no forward computes them, and the logits are finite."""
    model, params = pair["model"], pair["params"]
    assert model.cfg.rope_theta == 0.0

    def refuse(*args, **kw):
        raise AssertionError("rope tables computed at theta 0")

    monkeypatch.setattr(layers, "rope_tables", refuse)
    toks, pos = _tokens(model.cfg, 2, 9, 8)
    t, p = torch.from_numpy(toks), torch.from_numpy(pos)
    out = [model.forward(params, t, p, mode="train")[0]]
    cache = model.init_cache(2, 16)
    out.append(model.forward(params, t, p, mode="prefill", cache=cache)[0])
    out.append(model.forward(params, t[:, :1], p[:, :1] + 9, mode="decode",
                             cache=cache)[0])
    assert all(bool(torch.isfinite(o).all()) for o in out)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tokens(pair):
    """The mix's prompts and the JAX StaticBatchEngine's greedy tokens."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, pair["model"].cfg.vocab_size, size=n)
               for n, _ in REQUESTS]
    gens = [g for _, g in REQUESTS]
    jstatic = JaxStatic(jmodel, jparams, max_len=32, batch=1)
    want = [np.asarray(jstatic.generate(jnp.asarray(p)[None], n_steps=g))[0]
            for p, g in zip(prompts, gens)]
    return prompts, gens, want


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_engines_match_jax_static_token_for_token(pair, jax_tokens,
                                                  paged_kernel):
    """Temperature 0: the continuous engine (the recurrent prefill in
    decode mode, chunk 4; a preemption, a mid-run admission) with the
    paged kernel on and off, and the port's static engine (the SSD
    prefill), against the JAX StaticBatchEngine."""
    model, params = pair["model"], pair["params"]
    prompts, gens, want = jax_tokens
    eng = ContinuousBatchingEngine(model, params, paged_kernel=paged_kernel,
                                   **ENGINE)
    assert (eng._page_idx is not None) == paged_kernel
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    reqs = eng.requests()
    assert sum(r.n_preemptions for r in reqs) >= 1
    assert any(r.admit_step > 0 for r in reqs)
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for rid, p, g, w in zip(rids, prompts, gens, want):
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(
            static.generate(p[None], n_steps=g)[0].numpy(), w)


def test_prefix_cache_request_warns_and_runs_without_pool(pair):
    model, params = pair["model"], pair["params"]
    assert not model.decode_state.prefix_cachable
    assert not model.decode_state.token_addressable
    with pytest.warns(UserWarning, match="prefix_cache=True ignored"):
        eng = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                       page_size=8, prefix_cache=True)
    rid = eng.submit(np.arange(1, 6), 2)
    assert len(eng.run()[rid]) == 2


@pytest.mark.parametrize("static,int8", [(True, False), (False, False),
                                         (True, True)])
def test_launch_serve_runs_on_the_cpu(static, int8):
    res = launch_serve.run(ARCH, reduced=True, device="cpu", slots=2,
                           requests=3, prompt_len=12, gen_len=4,
                           prefill_chunk=4, page_size=8, static=static,
                           int8=int8)
    assert res["family"] == "hybrid"
    assert res["requests"] == (2 if static else 3)
    assert all(len(t) == 4 for t in res["tokens"].values())
    assert res["generated_tokens"] == 4 * res["requests"]
    assert (res["param_bytes"] < res["init_param_bytes"]) == int8
    assert res["run_ms"] is None and res["peak_gib"] is None
    assert f"{ARCH} (hybrid)" in launch_serve.report(res)


def test_launch_train_runs_hybrid_on_the_cpu():
    """The synthetic stream and the loss take the hybrid as the moe: two
    AdamW steps of the reduced config, finite losses with moe_aux."""
    out = launch_train.run(reduced_config(ARCH), steps=2, batch=2, seq=16,
                           ckpt_dir=None, device="cpu")
    log = out["log"]
    assert len(log) == 2
    assert all(np.isfinite(r["loss"]) and r["moe_aux"] > 0 for r in log)
