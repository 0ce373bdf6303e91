"""The port's ``LM.forward`` decode and prefill modes against the JAX
``LM`` on reduced ``granite-3-2b`` and ``qwen3-1.7b`` (qk-norm; at the
reduced head_dim 32 and at qwen3's own 128), fp32 on the CPU, with the
same weights carried over by ``params_from_numpy``.

Three decode-mode calls per config: a ragged chunk (rows with n_valid
S, 3 and 0), a single-token step (n_valid 1, 1, 0), and an all-full
step.  Prefill: a prompt from position 0, then a decode step on the
cache it left.  Logits must agree to ``atol = rtol = 1e-4``; the KV
cache and position counters must agree too.  Both engines of the dense
family against the JAX StaticBatchEngine: identical greedy tokens on
``tests/test_serve_families.py``'s request mix.  Also the weight bridge
(bf16 bits carried exactly) and the in-place row primitives.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import StaticBatchEngine as JaxStatic
from repro_torch.configs import reduced_config
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine, StaticBatchEngine
from repro_torch.weights import params_from_numpy, tensor_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def _models(arch, **overrides):
    jcfg = jax_reduced_config(arch, **overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = LM(reduced_config(arch, **overrides), device="cpu")
    return jmodel, jparams, model, params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("arch,head_dim", [
    ("granite-3-2b", 32), ("qwen3-1.7b", 32), ("qwen3-1.7b", 128)])
def test_decode_logits_match_jax(arch, head_dim):
    jmodel, jparams, model, params = _models(arch, head_dim=head_dim)
    cfg = model.cfg
    B, S, L = 3, 5, 32
    jcache = jmodel.init_cache(B, L)
    cache = model.init_cache(B, L)
    rng = np.random.default_rng(1)
    pos = np.zeros(B, np.int64)
    for n_valid in ([S, 3, 0], [1, 1, 0], [S, S, S]):
        width = max(n_valid) if max(n_valid) > 1 else 1
        toks = rng.integers(1, cfg.vocab_size, size=(B, width))
        positions = pos[:, None] + np.arange(width)[None]
        nv = np.asarray(n_valid, np.int32)
        jlogits, jcache, _ = jmodel.forward(
            jparams, jnp.asarray(toks, jnp.int32),
            jnp.asarray(positions, jnp.int32), mode="decode", cache=jcache,
            n_valid=jnp.asarray(nv))
        logits, cache = model.forward(
            params, torch.from_numpy(toks), torch.from_numpy(positions),
            mode="decode", cache=cache, n_valid=torch.from_numpy(nv))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        pos = pos + nv
    np.testing.assert_array_equal(cache["pos"].numpy(), pos)
    np.testing.assert_array_equal(
        np.asarray(jcache["layers"]["pos"]), np.broadcast_to(pos, (4, B)))
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(jcache["layers"]["k"]), **TOL)
    np.testing.assert_allclose(cache["v"].numpy(),
                               np.asarray(jcache["layers"]["v"]), **TOL)


@pytest.mark.parametrize("arch,head_dim", [
    ("granite-3-2b", 32), ("qwen3-1.7b", 32), ("qwen3-1.7b", 128)])
def test_prefill_logits_and_cache_match_jax(arch, head_dim):
    """Prefill logits, the K/V written to cache positions [0, S) (the rest
    left zero) and ``pos``; then a decode step on that cache."""
    jmodel, jparams, model, params = _models(arch, head_dim=head_dim)
    B, S, L = 2, 11, 32
    rng = np.random.default_rng(4)
    toks = rng.integers(1, model.cfg.vocab_size, size=(B, S))
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos, jnp.int32), mode="prefill",
                               cache=jmodel.init_cache(B, L))
    logits, cache = model.forward(params, torch.from_numpy(toks),
                                  torch.from_numpy(pos), mode="prefill",
                                  cache=model.init_cache(B, L))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(jc["layers"][k]), **TOL)
        assert cache[k][:, :, S:].abs().sum() == 0
    assert cache["pos"].tolist() == [S] * B
    np.testing.assert_array_equal(np.asarray(jc["layers"]["pos"]), S)
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    step = np.full((B, 1), S)
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(nxt, jnp.int32),
                              jnp.asarray(step, jnp.int32), mode="decode",
                              cache=jc)
    logits, _ = model.forward(params, torch.from_numpy(nxt),
                              torch.from_numpy(step), mode="decode",
                              cache=cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-1.7b"])
def test_dense_engines_match_jax_static_token_for_token(arch):
    """The continuous engine (2 slots, page 8, chunk 4, a 4-page budget: a
    preemption and a mid-run admission) and the static engine (its
    prefill the dense prefill mode) against the JAX StaticBatchEngine."""
    jmodel, jparams, model, params = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, model.cfg.vocab_size, size=n)
               for n in (15, 15, 7)]
    gens = [5, 4, 6]
    jstatic = JaxStatic(jmodel, jparams, max_len=32, batch=1)
    want = [np.asarray(jstatic.generate(jnp.asarray(p)[None], n_steps=g))[0]
            for p, g in zip(prompts, gens)]
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_len=32,
                                   page_size=8, prefill_chunk=4,
                                   page_budget=4)
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
    batch = StaticBatchEngine(model, params, max_len=32, batch=2).generate(
        np.stack([prompts[0], prompts[1]]), n_steps=4)
    np.testing.assert_array_equal(batch[0].numpy(), want[0][:4])
    np.testing.assert_array_equal(batch[1].numpy(), want[1][:4])


def test_paged_map_matches_dense_cache_path():
    """The engine's identity page map (page 8) and the dense-cache path
    (``paged=None``) give the same logits: the page walk is layout
    only."""
    from repro_torch.models.attention import PagedDecodeState
    _, _, model, params = _models("granite-3-2b")
    B, S, L = 2, 4, 32
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, 500, size=(B, S)))
    positions = torch.arange(S)[None].expand(B, S)
    nv = torch.tensor([4, 2], dtype=torch.int32)
    ident = torch.arange(B * L // 8, dtype=torch.int32).view(B, L // 8)
    a, _ = model.forward(params, toks, positions, cache=model.init_cache(B, L),
                         n_valid=nv)
    b, _ = model.forward(params, toks, positions, cache=model.init_cache(B, L),
                         n_valid=nv, paged=PagedDecodeState(ident, 8))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_row_primitives_update_in_place():
    _, _, model, params = _models("granite-3-2b")
    cache = model.init_cache(3, 16)
    row = model.cache_row(cache, 1)
    toks = torch.ones((1, 4), dtype=torch.long)
    model.forward(params, toks, torch.arange(4)[None], cache=row)
    # the batch-1 forward wrote straight into slot 1
    assert cache["pos"].tolist() == [0, 4, 0]
    assert cache["k"][:, 1, :4].abs().sum() > 0
    assert cache["k"][:, [0, 2]].abs().sum() == 0
    model.set_cache_row(cache, 1, row)                  # no-op on a view
    copy = {k: v.clone() for k, v in model.cache_row(cache, 1).items()}
    model.reset_cache_slots(cache, torch.tensor([False, True, False]))
    assert cache["pos"].tolist() == [0, 0, 0]
    assert cache["k"].abs().sum() == 0
    model.set_cache_row(cache, 2, copy)                 # copy into slot 2
    assert cache["pos"].tolist() == [0, 0, 4]
    torch.testing.assert_close(cache["k"][:, 2], copy["k"][:, 0])


def test_bfloat16_weights_carry_bit_exact():
    jcfg = jax_reduced_config("granite-3-2b", param_dtype="bfloat16")
    jparams = jax_build_model(jcfg).init_params(jax.random.key(1))
    table = np.asarray(jparams["embed"]["table"])
    t = tensor_from_numpy(table, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  table.astype(np.float32))


def test_unported_modes_and_families_raise():
    """The dense prefill mode runs (it fills the cache's first positions);
    a family that does not exist raises (the port serves all six of the
    reference's)."""
    from repro_torch.configs import get_config
    import dataclasses
    _, _, model, params = _models("granite-3-2b")
    cache = model.init_cache(1, 8)
    logits, cache = model.forward(
        params, torch.ones((1, 3), dtype=torch.long),
        torch.arange(3)[None], mode="prefill", cache=cache)
    assert logits.shape == (1, 3, model.cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["pos"].tolist() == [3]
    assert cache["k"][:, :, :3].abs().sum() > 0
    assert cache["k"][:, :, 3:].abs().sum() == 0
    nope = dataclasses.replace(get_config("granite-3-2b"), family="nope")
    with pytest.raises(ValueError, match="no DecodeState adapter"):
        LM(nope, device="cpu")
