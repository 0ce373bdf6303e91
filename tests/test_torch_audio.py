"""The port's audio family (reduced ``whisper-base``: 2 encoder and 2
decoder layers over 24 audio frames, MHA, GELU MLPs, RoPE in place of
the learned positions) against the JAX package on the CPU, fp32, with
the same weights carried over by ``params_from_numpy``:

- the GELU MLP (``jax.nn.gelu``'s tanh form, not the erf one);
- ``encode_audio`` (non-causal attention with RoPE at frame positions,
  then the encoder's norm) within 1e-4;
- the decoder layer (self-attention, the ungated cross-attention, the
  MLP) in train, prefill and decode modes against the reference's
  ``_period_step``: y and the caches it writes;
- the ``LM`` in train, prefill and decode (ragged ``n_valid``) modes:
  logits within 1e-4; the state after prefill and each ragged step (self
  K/V, ``pos``, ``cross_k`` / ``cross_v``), the cross K/V unchanged bit
  for bit by decode steps;
- ``install_slot_context`` (the encoder, then the cross K/V) against the
  reference's;
- the weight bridge both ways (``encoder.stack`` included), bit for bit;
  ``init_params(int8=True)`` bitwise ``quantize_params(init_params(g))``
  (encoder layers quantized too); the int8 logits against the JAX int8
  forward; ``init_param_bytes`` of the full config against the reference
  tree's bytes (``jax.eval_shape``);
- both engines (``paged_kernel`` True and False) and the static engine
  token for token against the JAX ``StaticBatchEngine`` on
  ``tests/test_serve_families.py``'s mix;
- ``submit``'s refusals and ``launch.serve.run`` (static, continuous) on
  the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models.decode_state import stub_context as jax_stub_context
from repro.models.quant import quantize_params as jax_quantize_params
from repro.serve import StaticBatchEngine as JaxStatic
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, blocks, layers
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_params
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-base"
REQUESTS = [(15, 5), (15, 4), (7, 6)]
PAGE = 8


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


def _frames(cfg, B, seed, scale=0.5):
    return jax_stub_context(cfg, np.random.default_rng(seed), batch=B,
                            scale=scale)["audio_frames"]


def _jax_state(jc):
    lay = jc["layers"]
    out = {k: np.asarray(lay["self"][k]) for k in ("k", "v")}
    out["pos"] = np.asarray(lay["self"]["pos"])[0]
    for k in ("cross_k", "cross_v"):
        out[k] = np.asarray(lay[k])
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


def test_gelu_mlp_matches_jax():
    """Up, GELU (the tanh form ``jax.nn.gelu`` defaults to), down; the erf
    form would miss 1e-4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 2
    p = {"up": {"w": rng.standard_normal((16, 32)).astype(np.float32)},
         "down": {"w": rng.standard_normal((32, 16)).astype(np.float32)}}
    want = np.asarray(jax_layers.mlp(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p)))
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    got = layers.mlp(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["up"]["w"]) @ \
        tp["down"]["w"]
    assert np.abs(erf.numpy() - want).max() > 1e-3


def test_encode_audio_matches_jax(pair):
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    frames = _frames(model.cfg, 2, 1)
    jenc, jaux = jmodel.encode_audio(jparams, jnp.asarray(frames))
    enc, aux = model.encode_audio(params, torch.from_numpy(frames))
    assert enc.shape == (2, model.cfg.n_audio_ctx, model.cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_decoder_layer_matches_jax(pair, mode):
    """One decoder layer (``blocks.attn_layer`` with ``xattn``) against
    the reference's audio ``_period_step``: train and prefill over the
    encoder's output (prefill writing its self and cross K/V into the
    layer's cache views), decode (ragged n_valid 3, 1, 0) over a cache
    whose cross K/V it only reads."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    cfg = model.cfg
    p = params["stack"][0]
    assert sorted(p) == ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]
    assert sorted(p["mlp"]) == ["down", "up"] and "gate_attn" not in \
        p["xattn"]
    jp = jax.tree.map(lambda a: a[0], jparams["stack"])
    rng = np.random.default_rng(3)
    B, S, L = 3, 6, 16
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    ctx, _ = jmodel.encode_audio(jparams, jnp.asarray(_frames(cfg, B, 2)))
    jc = jax.tree.map(lambda a: a[0], jmodel.init_cache(B, L)["layers"])
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    nv = None
    if mode == "decode":
        _, jc, _ = jmodel._period_step(jnp.asarray(x), jp, jc,
                                       mode="prefill",
                                       positions=jnp.asarray(pos), ctx=ctx)
        pos = pos + S
        nv = np.array([3, 1, 0], np.int32)
    cache = {k: torch.from_numpy(np.array(jc[k]))
             for k in ("cross_k", "cross_v")}
    self_kv = {k: torch.from_numpy(np.array(jc["self"][k]))
               for k in ("k", "v")}
    before = {k: v.clone() for k, v in cache.items()}
    jy, jnc, _ = jmodel._period_step(
        jnp.asarray(x), jp, jc, mode=mode, positions=jnp.asarray(pos),
        ctx=None if mode == "decode" else ctx,
        n_valid=None if nv is None else jnp.asarray(nv))
    tpos = torch.from_numpy(pos)
    rope = model._rope(tpos)
    write = None
    if mode == "decode":
        write = attention.decode_write(
            torch.from_numpy(np.array(jc["self"]["pos"])), S, L,
            torch.from_numpy(nv))
    y, _ = blocks.attn_layer(
        p, torch.from_numpy(x), cfg, mode=mode, rope=rope, positions=tpos,
        cache=None if mode == "train" else self_kv, write=write,
        ctx=None if mode == "decode" else torch.from_numpy(np.array(ctx)),
        cross=None if mode == "train" else {"k": cache["cross_k"],
                                            "v": cache["cross_v"]})
    got, want = y.numpy(), np.asarray(jy)
    if nv is not None:                    # the valid columns of each row
        for r, n in enumerate(nv):
            np.testing.assert_allclose(got[r, :n], want[r, :n], **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    if mode == "train":
        return
    for k in ("k", "v"):
        np.testing.assert_allclose(self_kv[k].numpy(),
                                   np.asarray(jnc["self"][k]), **TOL)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jnc[k]),
                                   **TOL)
        if mode == "decode":
            assert torch.equal(cache[k], before[k])


def test_weights_carry_the_encoder_tree_both_ways(pair):
    params, tree = pair["params"], pair["tree"]
    assert len(params["stack"]) == 2
    assert len(params["encoder"]["stack"]) == 2
    assert sorted(params["encoder"]) == ["final_norm", "stack"]
    assert sorted(params["encoder"]["stack"][0]) == ["attn", "ln1", "ln2",
                                                     "mlp"]
    a, b = _flat(tree), _flat(params_to_numpy(params))
    assert sorted(a) == sorted(b)
    assert "encoder/stack/attn/wq/w" in a and "stack/xattn/wk/w" in a
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_logits_in_every_mode_match_jax(pair):
    """Train (the encoder's aux added), a prefill from position 0 with the
    batch's frames and the state it leaves, then ragged decode steps:
    logits of the valid columns and the whole state; the cross K/V never
    change after the prefill."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    B, S, L = 3, 11, 32
    toks, pos = _tokens(model.cfg, B, S, 4)
    frames = _frames(model.cfg, B, 5)
    jx = {"audio_frames": jnp.asarray(frames)}
    tx = {"audio_frames": torch.from_numpy(frames)}
    jl, _, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                 jnp.asarray(pos), mode="train", extra=jx)
    logits, _, aux = model.forward(params, torch.from_numpy(toks),
                                   torch.from_numpy(pos), mode="train",
                                   extra=tx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == float(jaux) == 0.0
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(B, L), extra=jx)
    logits, cache = model.forward(params, torch.from_numpy(toks),
                                  torch.from_numpy(pos), mode="prefill",
                                  cache=model.init_cache(B, L), extra=tx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    _assert_state(cache, jc)
    cross = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
    at = np.full(B, S)
    rng = np.random.default_rng(6)
    for n_valid in ([2, 0, 3], [1, 1, 1]):
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
        for r, n in enumerate(n_valid):
            np.testing.assert_allclose(logits[r, :n].numpy(),
                                       np.asarray(jl)[r, :n], **TOL)
        _assert_state(cache, jc)
        for k in cross:
            assert torch.equal(cache[k], cross[k])
        at = at + nv


def test_install_slot_context_matches_jax(pair):
    """One request's (1, T, d) frames installed into slot 0 of a 2-slot
    cache: the encoder runs, then each layer's cross K/V; slot 1 stays
    zero."""
    jmodel, jparams, model, params = (pair[k] for k in (
        "jmodel", "jparams", "model", "params"))
    frames = _frames(model.cfg, 1, 8)                      # (1, T, d)
    jc = jmodel.install_slot_context(jparams, jmodel.init_cache(2, 16),
                                     jnp.int32(0),
                                     {"audio_frames": jnp.asarray(frames)})
    cache = model.install_slot_context(params, model.init_cache(2, 16), 0,
                                       {"audio_frames": frames})
    want = _jax_state(jc)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(cache[k][:, 0].numpy(), want[k][:, 0],
                                   **TOL)
        assert not cache[k][:, 1].any()


def test_int8_tree_and_logits_match_jax(pair):
    """``init_params(int8=True)`` (encoder layers quantized as drawn) is
    ``quantize_params(init_params(g))`` bit for bit; the reference's int8
    tree carried over gives the JAX int8 forward's prefill logits."""
    jmodel, jparams, model = pair["jmodel"], pair["jparams"], pair["model"]
    whole = quantize_params(model.init_params(
        torch.Generator().manual_seed(3)))
    layered = model.init_params(torch.Generator().manual_seed(3), int8=True)
    a, b = _flat(params_to_numpy(whole)), _flat(params_to_numpy(layered))
    assert sorted(a) == sorted(b)
    assert "encoder/stack/mlp/up/q" in a and "stack/xattn/wo/q" in a
    for key in a:
        np.testing.assert_array_equal(a[key].view(np.uint8),
                                      b[key].view(np.uint8), err_msg=key)
    jq = jax_quantize_params(jparams)
    qp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    assert qp["encoder"]["stack"][1]["attn"]["wk"]["q"].dtype == torch.int8
    toks, pos = _tokens(model.cfg, 2, 9, 7)
    frames = _frames(model.cfg, 2, 9)
    jl, _, _ = jmodel.forward(jq, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(pos, jnp.int32), mode="prefill",
                              cache=jmodel.init_cache(2, 16),
                              extra={"audio_frames": jnp.asarray(frames)})
    logits, _ = model.forward(qp, torch.from_numpy(toks),
                              torch.from_numpy(pos), mode="prefill",
                              cache=model.init_cache(2, 16),
                              extra={"audio_frames":
                                     torch.from_numpy(frames)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


def test_init_param_bytes_match_the_reference_tree():
    """whisper-base whole in bf16: the reference tree's bytes
    (``jax.eval_shape``), 97.27 M parameters (``param_counts`` says 90.98
    M: it leaves out the decoder's ``xattn``)."""
    jmodel = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(jmodel.init_params, jax.random.key(0))
    want = sum(int(np.prod(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(shapes))
    assert LM(get_config(ARCH), device="cpu").init_param_bytes() == want
    assert 194e6 < want < 195e6


@pytest.fixture(scope="module")
def jax_tokens(pair):
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
    """Temperature 0: the continuous engine (the encoder and the cross K/V
    at every admission, a preempted request's again; chunk 4) with the
    paged kernel on and off, and the port's static engine, against the
    JAX StaticBatchEngine."""
    model, params = pair["model"], pair["params"]
    prompts, gens, extras, want = jax_tokens
    aux = -(-model.cfg.n_audio_ctx // PAGE)
    eng = ContinuousBatchingEngine(model, params, paged_kernel=paged_kernel,
                                   n_slots=2, max_len=32, page_size=PAGE,
                                   prefill_chunk=4, page_budget=4 + 2 * aux)
    rids = [eng.submit(p, g, extra=e)
            for p, g, e in zip(prompts, gens, extras)]
    out = eng.run()
    reqs = eng.requests()
    assert sum(r.n_preemptions for r in reqs) >= 1
    assert any(r.admit_step > 0 for r in reqs)
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for rid, p, g, e, w in zip(rids, prompts, gens, extras, want):
        np.testing.assert_array_equal(out[rid], w)
        np.testing.assert_array_equal(
            static.generate(p[None], n_steps=g, extra={
                k: v[None] for k, v in e.items()})[0].numpy(), w)


def test_submit_refuses_missing_and_unknown_context(pair):
    """audio requires ``audio_frames``; a family without context refuses
    any."""
    model, params = pair["model"], pair["params"]
    eng = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                   page_size=8)
    frames = _frames(model.cfg, 1, 1)
    with pytest.raises(ValueError, match="requires extra"):
        eng.submit(np.arange(1, 5), 2, extra={"image_embeds": frames[0]})
    with pytest.raises(ValueError, match=r"\(T, d\) or \(1, T, d\)"):
        eng.submit(np.arange(1, 5), 2,
                   extra={"audio_frames": np.concatenate([frames] * 2)})
    dense = LM(reduced_config("granite-3-2b"), device="cpu")
    eng = ContinuousBatchingEngine(
        dense, dense.init_params(torch.Generator().manual_seed(0)),
        n_slots=1, max_len=16, page_size=8)
    with pytest.raises(ValueError, match="takes no extra"):
        eng.submit(np.arange(1, 5), 2, extra={"audio_frames": frames[0]})


@pytest.mark.parametrize("static", [True, False])
def test_launch_serve_runs_on_the_cpu(static):
    res = launch_serve.run(ARCH, reduced=True, device="cpu", slots=2,
                           requests=3, prompt_len=12, gen_len=4,
                           prefill_chunk=4, page_size=8, static=static)
    assert res["family"] == "audio"
    assert res["requests"] == (2 if static else 3)
    assert all(len(t) == 4 for t in res["tokens"].values())
    assert f"{ARCH} (audio)" in launch_serve.report(res)
