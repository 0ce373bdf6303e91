"""The port's prefix cache against the reference, on the CPU.

- ``decode_state.copy_state_prefix`` and ``adjust_state_counters``
  against the JAX functions on the same numpy state and specs (the
  port's layout: K/V entries, a ``pos`` counter, a cross K/V leaf and a
  float leaf of no token axis), ``src == dst`` included: the port's
  in-place update gives the JAX functions' new state;
- ``LM.install_cache_prefix`` / ``adjust_cache_counters`` on a live
  cache: the copied prefix's logits equal a cold prefill's;
- tests/test_serve_prefix.py's ``test_prefix_hit_matches_cold_run_under
  _preemption`` over its five families: the port's tokens with the
  prefix cache on equal its tokens with it off and the JAX engine's with
  it on; the cachable families hit (``prefix_hit_tokens`` and
  ``prefix_hit_rate`` equal to the reference's), the recurrent ones warn
  and never hit; no page leaks after a drain.

Reduced fp32 configs, the JAX tree carried over by ``params_from_numpy``
(every ``gate_attn`` 0.5).  Every port engine runs under the port's
shadow-state checker (``_DEFAULT_CHECK``), the JAX ones with
``check=True``: no error finding.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import decode_state as jax_decode_state
from repro.models.decode_state import stub_context
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.models import decode_state
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import params_from_numpy

FAMILY_ARCHS = [
    ("lm", "granite-3-2b"),
    ("ssm", "mamba2-780m"),
    ("hybrid", "jamba-v0.1-52b"),
    ("vlm", "llama-3.2-vision-90b"),
    ("audio", "whisper-base"),
]
PAGE = 8
GATE = 0.5


@pytest.fixture(autouse=True)
def port_shadow_checker(monkeypatch):
    """Every port engine built in a test runs with ``check=True``; at
    teardown none may hold an error finding."""
    built = []
    orig = ContinuousBatchingEngine.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        built.append(self)

    monkeypatch.setattr(ContinuousBatchingEngine, "_DEFAULT_CHECK", True)
    monkeypatch.setattr(ContinuousBatchingEngine, "__init__", init)
    yield
    errors = [f.format() for eng in built for f in eng.check_findings
              if f.severity == "error"]
    assert not errors, "\n".join(errors)


def _gated(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k == "gate_attn" else _gated(v))
                for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# the device primitives against the JAX functions
# ---------------------------------------------------------------------------
SPECS = {
    "self": {"k": (None, "batch", "kv_seq", "kv_heads", None),
             "v": (None, "batch", "kv_seq", "kv_heads", None),
             "pos": ("batch",)},
    "cross_k": (None, "batch", "image_tokens", "kv_heads", None),
    "h": (None, "batch", "heads", None, None),
}


def _numpy_state(B=4, S=12, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "self": {"k": rng.standard_normal((2, B, S, 2, 3)).astype(np.float32),
                 "v": rng.standard_normal((2, B, S, 2, 3)).astype(np.float32),
                 "pos": rng.integers(0, S, size=B).astype(np.int32)},
        "cross_k": rng.standard_normal((2, B, 5, 2, 3)).astype(np.float32),
        "h": rng.standard_normal((2, B, 2, 3, 4)).astype(np.float32),
    }


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _assert_tree(got, want):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=str(path))


@pytest.mark.parametrize("src,dst,n", [(0, 2, 7), (1, 1, 5), (3, 0, 0),
                                       (2, 1, 12)])
def test_copy_state_prefix_matches_jax(src, dst, n):
    state = _numpy_state()
    want = jax_decode_state.copy_state_prefix(
        jax.tree.map(jnp.asarray, state), SPECS, src, dst, n)
    got = _torch(state)
    ids = {k: id(v) for k, v in got["self"].items()}
    out = decode_state.copy_state_prefix(got, SPECS, src, dst, n)
    assert out is got and {k: id(v) for k, v in got["self"].items()} == ids
    _assert_tree(got, want)


def test_adjust_state_counters_matches_jax():
    state = _numpy_state()
    delta = np.array([0, 3, 1, 4], np.int32)
    want = jax_decode_state.adjust_state_counters(
        jax.tree.map(jnp.asarray, state), SPECS, jnp.asarray(delta))
    got = _torch(state)
    decode_state.adjust_state_counters(got, SPECS, torch.from_numpy(delta))
    _assert_tree(got, want)


def test_install_cache_prefix_gives_a_cold_prefills_logits():
    """A dense cache: prefill 16 tokens into slot 0, copy 8 of them to
    slot 1 and the first 8 of slot 0 onto itself (a trim), then decode
    the same 4 tokens after position 8 in both slots: the same logits,
    as a cold slot that prefilled those 8 tokens gives."""
    model = LM(reduced_config("granite-3-2b"), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, model.cfg.vocab_size, size=(1, 16)))
    cache = model.init_cache(3, 32)
    row = model.cache_row(cache, 0)
    model.forward(params, toks, torch.arange(16)[None], mode="decode",
                  cache=row)
    model.install_cache_prefix(cache, 0, 1, 8)
    model.install_cache_prefix(cache, 0, 0, 8)
    cold = model.cache_row(cache, 2)
    model.forward(params, toks[:, :8], torch.arange(8)[None],
                  mode="decode", cache=cold)
    assert cache["pos"].tolist() == [8, 8, 8]
    torch.testing.assert_close(cache["k"][:, 0], cache["k"][:, 1],
                               rtol=0, atol=0)
    nxt = toks[:, 8:12].expand(3, 4)
    logits, _ = model.forward(params, nxt, (8 + torch.arange(4))[None]
                              .expand(3, 4), mode="decode", cache=cache)
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
    torch.testing.assert_close(logits[2], logits[0], rtol=1e-5, atol=1e-5)
    # the speculative rewind: back 3 on slot 2 only
    model.adjust_cache_counters(cache, torch.tensor([0, 0, 3]))
    assert cache["pos"].tolist() == [12, 12, 9]


# ---------------------------------------------------------------------------
# engine: prefix-hit = cold = the JAX engine, five families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family,arch", FAMILY_ARCHS,
                         ids=[f for f, _ in FAMILY_ARCHS])
def test_prefix_hit_matches_cold_run_under_preemption(family, arch):
    """tests/test_serve_prefix.py's case: a shared 14-token prefix, three
    requests on 2 slots under an oversubscribed budget (a youngest-first
    preemption whose re-admission copies its own committed prefix).
    The port's warm tokens equal its cold tokens and the JAX warm
    engine's; hits as the reference's."""
    jmodel = jax_build_model(jax_reduced_config(arch))
    tree = _gated(jax.tree.map(np.asarray,
                               jmodel.init_params(jax.random.key(0))))
    jparams = jax.tree.map(jnp.asarray, tree)
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(tree, "cpu")
    cfg = model.cfg
    rng = np.random.default_rng(4)
    shared = rng.integers(1, cfg.vocab_size, size=14)
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab_size,
                                                    size=n)])
               for n in (1, 2, 3)]
    gens = (4, 3, 3)
    extra = stub_context(cfg, rng, scale=0.05)     # one shared context
    aux = -(-model.decode_state.context_tokens(cfg) // PAGE)
    kw = dict(n_slots=2, max_len=32, page_size=PAGE, prefill_chunk=4,
              page_budget=4 + 2 * aux)
    cachable = model.decode_state.prefix_cachable

    def run(cls, m, p, prefix_cache, **more):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = cls(m, p, prefix_cache=prefix_cache, **kw, **more)
        assert any("prefix_cache=True ignored" in str(w.message)
                   for w in caught) == (prefix_cache and not cachable)
        rids = [eng.submit(pr, g, extra=extra) for pr, g in zip(prompts, gens)]
        out = eng.run()
        return eng, [np.asarray(out[r]).tolist() for r in rids]

    cold_eng, cold = run(ContinuousBatchingEngine, model, params, False)
    warm_eng, warm = run(ContinuousBatchingEngine, model, params, True)
    jeng, jwarm = run(JaxEngine, jmodel, jparams, True, check=True)
    assert sum(r.n_preemptions for r in warm_eng.requests()) >= 1
    assert warm == cold, f"{family}: prefix-hit/cold token divergence"
    assert warm == jwarm, f"{family}: port/JAX token divergence"
    assert warm_eng.prefix_cache == cachable == jeng.prefix_cache
    mine, ref = warm_eng.stats.summary(), jeng.stats.summary()
    assert warm_eng.sched.prefix_hit_tokens == jeng.sched.prefix_hit_tokens
    for key in ("prefix_hit_tokens", "prefix_hit_rate", "generated_tokens"):
        assert mine[key] == pytest.approx(ref[key]), key
    if cachable:
        assert mine["prefix_hit_tokens"] > 0 and mine["prefix_hit_rate"] > 0
    else:
        assert mine["prefix_hit_tokens"] == 0
    assert not [f.row() for f in jeng.check_findings]
    for eng, outs in ((cold_eng, cold), (warm_eng, warm)):
        assert eng.stats.generated_tokens == sum(len(t) for t in outs)
    assert cold_eng.kv.table.n_used == 0
    assert warm_eng.kv.n_active == 0
    warm_eng.kv.clear_prefix_cache()
    assert warm_eng.kv.table.n_used == 0
