"""The port's vlm family (reduced ``llama-3.2-vision-90b``: one period of
4 attention layers and 1 gated cross-attention layer over 16 image
tokens, G 4) against the JAX package on the CPU, fp32, with the same
weights carried over by ``params_from_numpy`` — every ``gate_attn`` set
to 0.5 in the numpy tree first, since at its zero init ``tanh(0)`` drops
the cross path from the output:

- ``blocks.cross_layer`` in train, prefill and decode modes: y and the
  cross K/V within 1e-4; at the zero init the image does not matter;
- the ``LM`` in train, prefill and decode (ragged ``n_valid``) modes:
  logits within 1e-4; the state after prefill and each ragged step (self
  K/V, ``pos``, ``cross_k`` / ``cross_v``), the cross K/V unchanged bit
  for bit by decode steps and an ``n_valid`` 0 row's K/V kept;
- ``install_slot_context`` against the reference's: the slot's cross K/V,
  every other slot untouched bit for bit;
- the weight bridge both ways, bit for bit; ``init_params(int8=True)``
  bitwise ``quantize_params(init_params(g))``; the int8 logits against
  the JAX int8 forward; ``init_param_bytes`` of the full config against
  the reference tree's bytes (``jax.eval_shape``);
- both engines (``paged_kernel`` True and False) and the static engine
  token for token against the JAX ``StaticBatchEngine`` on
  ``tests/test_serve_families.py``'s mix (a preemption, so a re-admitted
  request is installed again; a mid-run admission);
- ``submit``'s refusals, a depth off the period, ``stub_context`` and
  ``launch.serve.run`` (static, continuous, int8) on the CPU, whose
  continuous prompts follow the reference launcher's draws.
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
from repro.models.decode_state import stub_context as jax_stub_context
from repro.models.quant import quantize_params as jax_quantize_params
from repro.serve import StaticBatchEngine as JaxStatic
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks
from repro_torch.models.decode_state import stub_context
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llama-3.2-vision-90b"
GATE = 0.5
# tests/test_serve_families.py's mix: two 15-token prompts whose decode
# growth crosses a page under a 4-page budget (a preemption), and a
# short third request admitted mid-run into a recycled slot; each request
# pins its image's pages on top
REQUESTS = [(15, 5), (15, 4), (7, 6)]
PAGE = 8


def _gated(tree):
    """The numpy tree with every gate_attn set to GATE."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k == "gate_attn" else _gated(v))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(jax_reduced_config(ARCH))
    tree = _gated(jax.tree.map(np.asarray,
                               jmodel.init_params(jax.random.key(0))))
    model = LM(reduced_config(ARCH), device="cpu")
    return dict(jmodel=jmodel, jparams=jax.tree.map(jnp.asarray, tree),
                tree=tree, model=model, params=params_from_numpy(tree, "cpu"))


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S))
    return toks, np.broadcast_to(np.arange(S), (B, S)).copy()


def _images(cfg, B, seed, scale=0.5):
    return jax_stub_context(cfg, np.random.default_rng(seed), batch=B,
                            scale=scale)["image_embeds"]


def _jax_state(jc):
    """The reference's {"periods": {"self", "cross_k", "cross_v"}} cache in
    the port's layout: the self K/V one entry a self-attention layer,
    period-major, and one position counter a slot."""
    per = jc["periods"]
    out = {k: np.asarray(per["self"][k]).reshape(
        (-1,) + per["self"][k].shape[2:]) for k in ("k", "v")}
    out["pos"] = np.asarray(per["self"]["pos"])[0, 0]
    for k in ("cross_k", "cross_v"):
        out[k] = np.asarray(per[k])
    return out


def _assert_state(cache, jc):
    want = _jax_state(jc)
    np.testing.assert_array_equal(cache["self"]["pos"].numpy(), want["pos"])
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["self"][k].numpy(), want[k],
                                   err_msg=k, **TOL)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[k].numpy(), want[k], err_msg=k,
                                   **TOL)


# ---------------------------------------------------------------------------
# the cross layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_layer_matches_jax(pair, mode):
    """Gated cross-attention + FFN over 16 image tokens: with the context
    (train, prefill: its K/V written into the layer's cache views) and
    over the cached K/V (decode, which writes nothing)."""
    jparams, model, params = pair["jparams"], pair["model"], pair["params"]
    cfg = model.cfg
    p = params["stack"][0]["cross"]
    assert sorted(p) == ["ln2", "lnx", "mlp", "xattn"]
    assert p["xattn"]["gate_attn"].shape == () and float(
        p["xattn"]["gate_attn"]) == GATE
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["cross"])
    rng = np.random.default_rng(1)
    B, S = 3, 9
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    ctx = _images(cfg, B, 2)
    jy, jkv, _ = jax_blocks.cross_layer(jp, jnp.asarray(x), pair[
        "jmodel"].cfg, ctx=jnp.asarray(ctx))
    shape = (B, cfg.num_image_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    if mode == "decode":
        cache = {"k": torch.from_numpy(np.array(jkv[0])),
                 "v": torch.from_numpy(np.array(jkv[1]))}
        jy, _, _ = jax_blocks.cross_layer(jp, jnp.asarray(x), pair[
            "jmodel"].cfg, cached_kv=jkv)
    before = {k: v.clone() for k, v in cache.items()}
    y, aux = blocks.cross_layer(
        p, torch.from_numpy(x), cfg, mode=mode,
        ctx=None if mode == "decode" else torch.from_numpy(ctx),
        cache=None if mode == "train" else cache)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert (aux is not None) == (mode == "train")
    if mode == "prefill":
        np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jkv[0]),
                                   **TOL)
        np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jkv[1]),
                                   **TOL)
    else:
        assert all(torch.equal(cache[k], before[k]) for k in cache)


def test_zero_gate_drops_the_image(pair):
    """At the initializer's gate_attn 0 the cross path adds nothing: two
    images give the same logits; at 0.5 they differ."""
    model, params = pair["model"], pair["params"]
    toks, pos = _tokens(model.cfg, 2, 7, 3)
    t, p = torch.from_numpy(toks), torch.from_numpy(pos)

    def logits(prm, seed):
        img = torch.from_numpy(_images(model.cfg, 2, seed))
        return model.forward(prm, t, p, mode="train",
                             extra={"image_embeds": img})[0]

    zero = model.init_params(torch.Generator().manual_seed(0))
    assert float(zero["stack"][0]["cross"]["xattn"]["gate_attn"]) == 0.0
    assert torch.equal(logits(zero, 4), logits(zero, 5))
    assert not torch.allclose(logits(params, 4), logits(params, 5))


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
def test_weights_carry_the_period_tree_both_ways(pair):
    """One stack entry a period: s0…s3 attention layers and the cross
    layer, its 0-d gate; the tree restacks to the reference's bit for
    bit, and a bf16 tree comes back unchanged."""
    params, tree = pair["params"], pair["tree"]
    assert len(params["stack"]) == 1
    assert sorted(params["stack"][0]) == ["cross", "s0", "s1", "s2", "s3"]
    a, b = _flat(tree), _flat(params_to_numpy(params))
    assert sorted(a) == sorted(b)
    assert "stack/cross/xattn/gate_attn" in a
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    bf = LM(reduced_config(ARCH, param_dtype="bfloat16"), device="cpu")
    p = bf.init_params(torch.Generator().manual_seed(0))
    again = params_from_numpy(params_to_numpy(p), "cpu")
    for x, y in zip(tree_leaves(p), tree_leaves(again)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_logits_match_jax(pair):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    toks, pos = _tokens(model.cfg, 2, 23, 1)
    img = _images(model.cfg, 2, 6)
    jl, _, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                 jnp.asarray(pos), mode="train",
                                 extra={"image_embeds": jnp.asarray(img)})
    logits, cache, aux = model.forward(
        params, torch.from_numpy(toks), torch.from_numpy(pos), mode="train",
        extra={"image_embeds": torch.from_numpy(img)})
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == float(jaux) == 0.0


def test_prefill_state_and_ragged_decode_match_jax(pair):
    """A prefill from position 0 with the batch's images and the state it
    leaves; then a ragged chunk (n_valid 3, 0, 2) and one-token steps:
    logits of the valid columns and the whole state; the cross K/V never
    change again, and the n_valid-0 row's self K/V is kept bit for
    bit."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    B, S, L = 3, 13, 32
    toks, pos = _tokens(model.cfg, B, S, 4)
    img = _images(model.cfg, B, 7)
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(B, L),
                               extra={"image_embeds": jnp.asarray(img)})
    logits, cache = model.forward(
        params, torch.from_numpy(toks), torch.from_numpy(pos),
        mode="prefill", cache=model.init_cache(B, L),
        extra={"image_embeds": torch.from_numpy(img)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_state(cache, jc)
    cross = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
    at = np.full(B, S)
    rng = np.random.default_rng(5)
    for n_valid in ([3, 0, 2], [1, 1, 1], [0, 1, 1]):
        width = max(n_valid)
        step = rng.integers(1, model.cfg.vocab_size, size=(B, width))
        positions = at[:, None] + np.arange(width)[None]
        nv = np.asarray(n_valid, np.int32)
        before = {k: cache["self"][k].clone() for k in ("k", "v")}
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
                for k in ("k", "v"):
                    assert torch.equal(cache["self"][k][:, r],
                                       before[k][:, r])
        _assert_state(cache, jc)
        for k in cross:
            assert torch.equal(cache[k], cross[k])
        at = at + nv
    assert cache["self"]["pos"].tolist() == at.tolist()


def test_install_slot_context_matches_jax(pair):
    """One request's (T, d) image installed into slot 1 of a 3-slot cache:
    that row's cross K/V as the reference's install, bit for bit zero
    elsewhere (the other slots untouched); a decode step over it gives
    the reference's logits."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    img = _images(model.cfg, 1, 8)[0]                       # (T, d)
    jc = jmodel.install_slot_context(jparams, jmodel.init_cache(3, 16),
                                     jnp.int32(1),
                                     {"image_embeds": jnp.asarray(img)})
    cache = model.install_slot_context(params, model.init_cache(3, 16), 1,
                                       {"image_embeds": img})
    want = _jax_state(jc)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[k][:, 1].numpy(), want[k][:, 1],
                                   **TOL)
        assert cache[k][:, 1].abs().sum() > 0
        assert not cache[k][:, [0, 2]].any()
        assert not cache["self"][k[-1]].any()
    step = np.full((3, 1), 4)
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(step, jnp.int32),
                              jnp.zeros((3, 1), jnp.int32), mode="decode",
                              cache=jc)
    logits, _ = model.forward(params, torch.from_numpy(step),
                              torch.zeros((3, 1), dtype=torch.long),
                              mode="decode", cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_int8_init_is_quantize_of_init_bitwise(pair):
    """Each sub-layer is quantized as it is drawn: the same bits as the
    whole tree quantized after the draw; the gate stays a 0-d float."""
    model = pair["model"]
    whole = quantize_params(model.init_params(
        torch.Generator().manual_seed(3)))
    layered = model.init_params(torch.Generator().manual_seed(3), int8=True)
    a, b = _flat(params_to_numpy(whole)), _flat(params_to_numpy(layered))
    assert sorted(a) == sorted(b)
    for key in ("stack/cross/xattn/wk/q", "stack/cross/mlp/gate/q",
                "stack/s2/attn/wo/scale", "unembed/table/q"):
        assert key in a, key
    assert a["stack/cross/xattn/gate_attn"].dtype == np.float32
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key].view(np.uint8),
                                      b[key].view(np.uint8), err_msg=key)


def test_int8_logits_match_jax_int8(pair):
    """The quantized trees (the reference's bits, carried over): train
    logits, then a prefill and a decode step, within 1e-4."""
    jmodel, jparams, model = pair["jmodel"], pair["jparams"], pair["model"]
    jq = jax_quantize_params(jparams)
    qp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert qp["stack"][0]["cross"]["xattn"]["wv"]["q"].dtype == torch.int8
    toks, pos = _tokens(model.cfg, 2, 10, 7)
    img = _images(model.cfg, 2, 9)
    jx, tx = ({"image_embeds": jnp.asarray(img)},
              {"image_embeds": torch.from_numpy(img)})
    jl, _, _ = jmodel.forward(jq, jnp.asarray(toks), jnp.asarray(pos),
                              mode="train", extra=jx)
    logits, _, _ = model.forward(qp, torch.from_numpy(toks),
                                 torch.from_numpy(pos), mode="train",
                                 extra=tx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    jl, jc, _ = jmodel.forward(jq, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(2, 16), extra=jx)
    _, cache = model.forward(qp, torch.from_numpy(toks),
                             torch.from_numpy(pos), mode="prefill",
                             cache=model.init_cache(2, 16), extra=tx)
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    step = np.full((2, 1), 10)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(step, jnp.int32), mode="decode",
                              cache=jc)
    logits, _ = model.forward(qp, torch.from_numpy(nxt),
                              torch.from_numpy(step), mode="decode",
                              cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_init_param_bytes_match_the_reference_tree():
    """The full config's tree in bf16, reckoned on the meta device, has the
    bytes of the reference's ``init_params`` tree (``jax.eval_shape``):
    20 periods of 4 attention layers and 1 cross layer, 87.67 G
    parameters (``param_counts`` says 90.69 G: it counts a cross block
    on top of every fifth layer)."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    want = sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(shapes))
    model = LM(get_config(ARCH), device="cpu")
    assert model.n_periods == 20
    assert model.init_param_bytes() == want
    assert 175e9 < want < 176e9


def test_lm_refuses_a_depth_off_the_period():
    with pytest.raises(ValueError, match="cross_attn_period"):
        LM(reduced_config(ARCH, n_layers=7), device="cpu")
    with pytest.raises(ValueError, match="cross_attn_period"):
        launch_serve.run(ARCH, reduced=True, layers=7, device="cpu")
    assert LM(reduced_config(ARCH, n_layers=10), device="cpu").n_periods == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tokens(pair):
    """The mix's prompts and images (drawn as tests/test_serve_families.py
    draws them) and the JAX StaticBatchEngine's greedy tokens."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, pair["model"].cfg.vocab_size, size=n)
               for n, _ in REQUESTS]
    extras = [jax_stub_context(jmodel.cfg, rng, scale=0.05)
              for _ in REQUESTS]
    gens = [g for _, g in REQUESTS]
    jstatic = JaxStatic(jmodel, jparams, max_len=32, batch=1)
    want = [np.asarray(jstatic.generate(
        jnp.asarray(p)[None], n_steps=g,
        extra={k: jnp.asarray(v)[None] for k, v in e.items()}))[0]
        for p, g, e in zip(prompts, gens, extras)]
    return prompts, gens, extras, want


@pytest.mark.parametrize("paged_kernel", [True, False])
def test_engines_match_jax_static_token_for_token(pair, jax_tokens,
                                                  paged_kernel):
    """Temperature 0: the continuous engine (chunk 4; a preemption, whose
    request is installed again at re-admission; a mid-run admission)
    with the paged kernel on and off, and the port's static engine,
    against the JAX StaticBatchEngine."""
    model, params = pair["model"], pair["params"]
    prompts, gens, extras, want = jax_tokens
    aux = -(-model.cfg.num_image_tokens // PAGE)
    eng = ContinuousBatchingEngine(model, params, paged_kernel=paged_kernel,
                                   n_slots=2, max_len=32, page_size=PAGE,
                                   prefill_chunk=4, page_budget=4 + 2 * aux)
    assert (eng._page_idx is not None) == paged_kernel
    installs = []
    install = model.install_slot_context

    def counting(params_, cache, slot, extra):
        installs.append(slot)
        return install(params_, cache, slot, extra)

    model.install_slot_context = counting
    try:
        rids = [eng.submit(p, g, extra=e)
                for p, g, e in zip(prompts, gens, extras)]
        out = eng.run()
    finally:
        del model.install_slot_context
    reqs = eng.requests()
    preempted = sum(r.n_preemptions for r in reqs)
    assert preempted >= 1 and any(r.admit_step > 0 for r in reqs)
    assert len(installs) == len(prompts) + preempted
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for rid, p, g, e, w in zip(rids, prompts, gens, extras, want):
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(
            static.generate(p[None], n_steps=g, extra={
                k: v[None] for k, v in e.items()})[0].numpy(), w)


def test_submit_refuses_a_missing_unknown_or_batched_context(pair):
    model, params = pair["model"], pair["params"]
    eng = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                   page_size=8)
    img = _images(model.cfg, 2, 1)
    prompt = np.arange(1, 5)
    with pytest.raises(ValueError, match="requires extra"):
        eng.submit(prompt, 2)
    with pytest.raises(ValueError, match="takes no extra"):
        eng.submit(prompt, 2, extra={"image_embeds": img[0],
                                     "audio_frames": img[0]})
    with pytest.raises(ValueError, match=r"\(T, d\) or \(1, T, d\)"):
        eng.submit(prompt, 2, extra={"image_embeds": img})
    rid = eng.submit(prompt, 2, extra={"image_embeds": img[:1]})
    assert len(eng.run()[rid]) == 2


def test_stub_context_draws_as_the_reference(pair):
    """Per request and batched: the reference's arrays from the same
    generator state."""
    cfg, jcfg = pair["model"].cfg, pair["jmodel"].cfg
    for batch in (None, 3):
        a = stub_context(cfg, np.random.default_rng(4), batch=batch)
        b = jax_stub_context(jcfg, np.random.default_rng(4), batch=batch)
        assert list(a) == list(b) == ["image_embeds"]
        np.testing.assert_array_equal(a["image_embeds"], b["image_embeds"])
    assert stub_context(reduced_config("granite-3-2b"),
                        np.random.default_rng(4)) is None


@pytest.mark.parametrize("static,int8", [(True, False), (False, False),
                                         (True, True)])
def test_launch_serve_runs_on_the_cpu(pair, static, int8):
    res = launch_serve.run(ARCH, reduced=True, device="cpu", slots=2,
                           requests=3, prompt_len=12, gen_len=4,
                           prefill_chunk=4, page_size=8, static=static,
                           int8=int8)
    assert res["family"] == "vlm"
    assert res["requests"] == (2 if static else 3)
    assert all(len(t) == 4 for t in res["tokens"].values())
    assert res["generated_tokens"] == 4 * res["requests"]
    assert (res["param_bytes"] < res["init_param_bytes"]) == int8
    assert res["run_ms"] is None and res["peak_gib"] is None
    assert f"{ARCH} (vlm)" in launch_serve.report(res)
    if not static:
        # the reference launcher's draws: a prompt length, the prompt,
        # then the request's image, from default_rng(1)
        rng = np.random.default_rng(1)
        for got in res["prompts"]:
            n = int(rng.integers(6, 13))
            np.testing.assert_array_equal(
                got, rng.integers(1, pair["model"].cfg.vocab_size, size=n))
            jax_stub_context(pair["jmodel"].cfg, rng)
