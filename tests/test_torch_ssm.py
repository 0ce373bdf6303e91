"""The port's ssm family (reduced ``mamba2-780m``) against the JAX
package on the CPU, fp32, with the same weights carried over by
``params_from_numpy``:

- the config registry: ``get_config`` / ``reduced_config`` equal to the
  JAX ones, field by field, for every arch the port registers;
- one mamba layer and the whole ``LM`` in train, prefill and decode
  modes (logits and state within 1e-4; decode with ragged ``n_valid``
  including 0, whose rows keep their state bit for bit);
- both engines token for token against the JAX ``StaticBatchEngine`` on
  ``tests/test_serve_families.py``'s request mix (forced preemption,
  mid-run admission), the port's static engine included;
- ``launch.serve.run`` on the CPU, static and continuous, ``--int8``,
  and the options it does not port yet.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_build_model
from repro.serve import StaticBatchEngine as JaxStatic
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch import serve as launch_serve
from repro_torch.models import blocks
from repro_torch.models.model import LM
from repro_torch.models.quant import matmul_q
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.weights import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mamba2-780m"
# tests/test_serve_families.py's mix: two 15-token prompts whose decode
# growth crosses a page under a 4-page budget (a preemption), and a
# short third request admitted mid-run into a recycled slot
REQUESTS = [(15, 5), (15, 4), (7, 6)]
PAGE = 8


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) \
            else v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    for mine, ref in ((get_config(arch), jax_get_config(arch)),
                      (reduced_config(arch), jax_reduced_config(arch))):
        got = _fields(mine)
        want = {k: _fields(ref)[k] for k in got}
        assert got == want


@pytest.fixture(scope="module")
def ssm():
    jcfg = jax_reduced_config(ARCH)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = LM(reduced_config(ARCH), device="cpu")
    return jmodel, jparams, tree, model, params_from_numpy(tree, "cpu")


def test_weights_carry_the_ssm_tree_both_ways(ssm):
    """The stack's ``ln1`` and ``mamba.*`` leaves split per layer and
    restack exactly; A_log, D and dt_bias stay fp32 in a bf16 tree."""
    _, _, tree, model, params = ssm
    assert sorted(params["stack"][0]) == ["ln1", "mamba"]
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = LM(reduced_config(ARCH, param_dtype="bfloat16"), device="cpu")
    p = bf.init_params(torch.Generator().manual_seed(0))
    m = p["stack"][0]["mamba"]
    assert {k for k, v in m.items() if v.dtype == torch.float32} == {
        "A_log", "D", "dt_bias"}
    assert p["stack"][0]["ln1"]["scale"].dtype == torch.bfloat16
    again = params_from_numpy(params_to_numpy(p), "cpu")
    for a, b in zip(jax.tree.leaves(p, is_leaf=torch.is_tensor),
                    jax.tree.leaves(again, is_leaf=torch.is_tensor)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _state(cache):
    return {k: v.numpy() for k, v in cache.items()}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_layer_matches_jax(ssm, mode):
    jmodel, jparams, tree, model, params = ssm
    cfg = model.cfg
    rng = np.random.default_rng(1)
    B, S = 3, 21
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["stack"])
    jstate = nv = None
    state = None
    if mode == "decode":
        jstate = jax.tree.map(lambda a: a[1],
                              jmodel.init_cache(B, 8)["layers"])
        jstate = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.1,
                                 v.dtype) for k, v in jstate.items()}
        state = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
        nv = np.array([S, 4, 0], np.int32)
    jy, jst, _ = jax_blocks.mamba_layer(
        jp, jnp.asarray(x), jmodel.cfg, mode=mode, state=jstate,
        n_valid=None if nv is None else jnp.asarray(nv))
    y, st, aux = blocks.mamba_layer(
        params["stack"][1], torch.from_numpy(x), cfg, mode=mode,
        state=state, n_valid=None if nv is None else torch.from_numpy(nv))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    if mode == "train":
        assert st is None and float(aux) == 0.0
    else:
        got = state if mode == "decode" else st
        for k in ("h", "conv"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(jst[k]),
                                       **TOL)


def test_lm_train_and_prefill_logits_match_jax(ssm):
    """Train logits; prefill logits and the cache it leaves (every
    layer's h and conv tail), S 37 over chunks of 16; a prompt shorter
    than the conv window (S 2) pads the tail on the left."""
    jmodel, jparams, _, model, params = ssm
    rng = np.random.default_rng(2)
    for B, S in ((2, 37), (3, 2)):
        toks = rng.integers(1, model.cfg.vocab_size, size=(B, S))
        pos = np.broadcast_to(np.arange(S), (B, S)).copy()
        jl, _, jaux = jmodel.forward(jparams, jnp.asarray(toks),
                                     jnp.asarray(pos), mode="train")
        logits, none, aux = model.forward(params, torch.from_numpy(toks),
                                          torch.from_numpy(pos),
                                          mode="train")
        assert none is None and float(aux) == float(jaux) == 0.0
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks),
                                   jnp.asarray(pos), mode="prefill",
                                   cache=jmodel.init_cache(B, 64))
        logits, cache = model.forward(params, torch.from_numpy(toks),
                                      torch.from_numpy(pos), mode="prefill",
                                      cache=model.init_cache(B, 64))
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jc["layers"][k]), **TOL)


def test_lm_decode_ragged_rows_match_jax(ssm):
    """Three decode calls after a prefill: a ragged chunk (n_valid 5, 2,
    0), single tokens (1, 0, 1) and all full.  Logits of the valid
    columns and the states match; a row with n_valid 0 keeps its state
    bit for bit."""
    jmodel, jparams, _, model, params = ssm
    rng = np.random.default_rng(3)
    B, S = 3, 9
    toks = rng.integers(1, model.cfg.vocab_size, size=(B, S))
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    _, jc, _ = jmodel.forward(jparams, jnp.asarray(toks), jnp.asarray(pos),
                              mode="prefill", cache=jmodel.init_cache(B, 32))
    _, cache = model.forward(params, torch.from_numpy(toks),
                             torch.from_numpy(pos), mode="prefill",
                             cache=model.init_cache(B, 32))
    for n_valid in ([5, 2, 0], [1, 0, 1], [3, 3, 3]):
        width = max(n_valid)
        t = rng.integers(1, model.cfg.vocab_size, size=(B, width))
        nv = np.asarray(n_valid, np.int32)
        before = {k: v.clone() for k, v in cache.items()}
        jl, jc, _ = jmodel.forward(jparams, jnp.asarray(t),
                                   jnp.zeros((B, width), jnp.int32),
                                   mode="decode", cache=jc,
                                   n_valid=jnp.asarray(nv))
        logits, cache = model.forward(
            params, torch.from_numpy(t), torch.zeros((B, width),
                                                     dtype=torch.long),
            mode="decode", cache=cache, n_valid=torch.from_numpy(nv))
        for r, n in enumerate(n_valid):
            np.testing.assert_allclose(logits[r, :n].numpy(),
                                       np.asarray(jl)[r, :n], **TOL)
            for k in ("h", "conv"):
                if n == 0:
                    assert torch.equal(cache[k][:, r], before[k][:, r])
        for k in ("h", "conv"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jc["layers"][k]), **TOL)


def test_state_row_primitives_on_the_recurrent_state(ssm):
    _, _, _, model, _ = ssm
    cache = model.init_cache(3, 16)
    for v in cache.values():
        v.normal_()
    row = model.cache_row(cache, 1)
    assert row["h"].shape[1] == 1 and row["h"].data_ptr() == \
        cache["h"][:, 1].data_ptr()
    keep = {k: v.clone() for k, v in cache.items()}
    model.reset_cache_slots(cache, torch.tensor([False, True, False]))
    for k in cache:
        assert (cache[k][:, 1] == 0).all()
        assert torch.equal(cache[k][:, 0], keep[k][:, 0])
        assert torch.equal(cache[k][:, 2], keep[k][:, 2])


def _jax_static_tokens(jmodel, jparams, prompts, gens):
    static = JaxStatic(jmodel, jparams, max_len=32, batch=1)
    return [np.asarray(static.generate(jnp.asarray(p)[None],
                                       n_steps=g))[0]
            for p, g in zip(prompts, gens)]


def test_engines_match_jax_static_token_for_token(ssm):
    """The continuous engine (recurrent prefill in decode mode, 2 slots,
    page 8, chunk 4, a 4-page budget) and the port's static engine (the
    SSD prefill) against the JAX StaticBatchEngine: identical greedy
    tokens.  The mix forces a preemption and a mid-run admission."""
    jmodel, jparams, _, model, params = ssm
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n, _ in REQUESTS]
    gens = [g for _, g in REQUESTS]
    want = _jax_static_tokens(jmodel, jparams, prompts, gens)

    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=PAGE, prefill_chunk=4,
                                   page_budget=4)
    assert eng._page_idx is None            # no paged context for ssm
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run()
    reqs = eng.requests()
    assert sum(r.n_preemptions for r in reqs) >= 1
    assert any(r.admit_step > 0 for r in reqs)
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(out[rid], w)

    before = ssd_kernel.ssd_scan_fwd.launches
    static = StaticBatchEngine(model, params, max_len=32, batch=1)
    for p, g, w in zip(prompts, gens, want):
        got = static.generate(p[None], n_steps=g)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), w)
    assert ssd_kernel.ssd_scan_fwd.launches == before   # the CPU: plain
    st = static.stats.summary()
    assert st["generated_tokens"] == sum(gens)
    assert st["steps"] == sum(gens) and st["step_ms_p50"] is None


def test_static_batch_matches_single_rows(ssm):
    """A batch of equal-length prompts in one static prefill gives each
    row the tokens it gets alone."""
    _, _, _, model, params = ssm
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, model.cfg.vocab_size, size=(3, 11))
    batch = StaticBatchEngine(model, params, max_len=32, batch=3).generate(
        prompts, n_steps=4)
    one = StaticBatchEngine(model, params, max_len=32, batch=1)
    for r in range(3):
        assert torch.equal(batch[r], one.generate(prompts[r:r + 1], 4)[0])


def test_prefix_cache_request_warns_and_runs_without_pool(ssm):
    _, _, _, model, params = ssm
    with pytest.warns(UserWarning, match="prefix_cache=True ignored"):
        eng = ContinuousBatchingEngine(model, params, n_slots=1, max_len=16,
                                       page_size=8, prefix_cache=True)
    rid = eng.submit(np.arange(1, 6), 2)
    assert len(eng.run()[rid]) == 2
    assert not eng.prefix_cache and eng.kv.prefix_pool == 0
    # a dense engine keeps the pool on
    dense = LM(reduced_config("granite-3-2b"), device="cpu")
    eng = ContinuousBatchingEngine(dense, dense.init_params(
        torch.Generator().manual_seed(0)), n_slots=1, max_len=16,
        page_size=8, prefix_cache=True)
    assert eng.prefix_cache and eng.kv.prefix_pool == 8


def test_dense_prefill_and_qpacks_are_not_ported_yet():
    """Both are ported now: the dense prefill mode gives the logits of the
    decode mode over the same prompt, and ``matmul_q`` of an int8 q-pack
    multiplies by the dequantized weight."""
    dense = LM(reduced_config("granite-3-2b"), device="cpu")
    params = dense.init_params(torch.Generator().manual_seed(0))
    toks = torch.arange(1, 5)[None]
    pos = torch.arange(4)[None]
    pre, cache = dense.forward(params, toks, pos, mode="prefill",
                               cache=dense.init_cache(1, 8))
    dec, _ = dense.forward(params, toks, pos, mode="decode",
                           cache=dense.init_cache(1, 8))
    torch.testing.assert_close(pre, dec, rtol=1e-4, atol=1e-4)
    assert cache["pos"].tolist() == [4]
    pack = {"q": torch.tensor([[1, -2, 3]] * 4, dtype=torch.int8),
            "scale": torch.tensor([0.5, 1.0, 2.0])}
    torch.testing.assert_close(matmul_q(torch.ones((2, 4)), pack),
                               torch.tensor([[2.0, -8.0, 24.0]] * 2))
    torch.testing.assert_close(matmul_q(torch.ones((2, 4)),
                                        torch.ones((4, 3))),
                               torch.full((2, 3), 4.0))


@pytest.mark.parametrize("static", [True, False])
def test_launch_serve_runs_on_the_cpu(static):
    res = launch_serve.run(ARCH, reduced=True, device="cpu", slots=2,
                           requests=3, prompt_len=12, gen_len=4,
                           prefill_chunk=4, page_size=8, static=static)
    assert res["engine"] == ("static" if static else "continuous")
    assert res["requests"] == (2 if static else 3)
    assert len(res["tokens"]) == res["requests"]
    assert all(len(t) == 4 for t in res["tokens"].values())
    assert res["generated_tokens"] == 4 * res["requests"]
    # no device times off the card
    assert res["run_ms"] is None and res["peak_gib"] is None
    assert "mamba2-780m (ssm)" in launch_serve.report(res)


def test_launch_serve_int8_flag_runs():
    """``--int8`` is ported: the launcher quantizes and serves."""
    res = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--int8", "--slots", "2", "--requests", "2",
                             "--prompt-len", "8", "--gen-len", "3"])
    assert res["int8"] and res["param_bytes"] < res["init_param_bytes"]
    assert all(len(t) == 3 for t in res["tokens"].values())


@pytest.mark.parametrize("flag,item", [
    ("--mesh=2", "A10"), ("--sp-kv", "A10"), ("--open-loop", "A7"),
    ("--chunk-policy=stall_free", "A7")])
def test_launch_serve_refuses_what_is_not_ported(flag, item):
    """The mesh options (A10) still raise.  A7's open-loop front end and
    stall-free chunk policy are ported: on the CPU they run through the
    front end's model clock, and every request completes."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", flag]
    if item != "A7":
        with pytest.raises(NotImplementedError, match=item):
            launch_serve.main(argv)
        return
    argv += ["--open-loop", "--clock", "model", "--rate", "1e4",
             "--slots", "2", "--requests", "3", "--prompt-len", "8",
             "--gen-len", "3"]
    if "stall_free" in flag:
        argv += ["--tbt-target", "1e-5"]
    res = launch_serve.main(argv)
    assert res["open_loop"] and res["clock"] == "model"
    assert res["latency"]["completed"] == res["requests"] == 3
    assert all(len(t) == 3 for t in res["tokens"].values())
    assert res["chunk_policy"] == ("stall_free" if "stall_free" in flag
                                   else "fixed")


def test_launch_serve_defaults_to_the_card(monkeypatch):
    seen = {}

    def fake_run(arch, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(launch_serve, "run", fake_run)
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", ARCH])
    assert seen["device"] == "cuda"
