"""The sequence-parallel (SP-KV) decode against the reference.

``decode_partials`` (the plain version, the CPU path) against the
reference's jnp ``decode_partials`` on the same inputs, made with numpy
from a seed: a slice of the cache at ``kv_offset`` 0, mid-range and past
every row's ``kv_valid``, a decode column and a chunk of 8 (some of whose
columns lie before the slice: a negative shifted position), softcap 0 and
30, a slice length no tile of the kernel divides.  fp32 on the CPU: the
tolerance is fp32 roundoff of a softmax over <= 40 keys (1e-5).  Where a
query has no valid key in the slice the two packages' partials differ by
design (the port's m = NEG_INF, l = 0, acc = 0; the reference's l counts
the slice and acc sums v); the cross-slice combine weighs either by 0, and
the combined outputs agree.

Then ``_attn_decode_spkv`` through the model on 2 gloo CPU ranks (mesh
1x2, the cache length over the model axis; once with the reference's
rules, where the reduced config's heads stay whole, once with the heads
split, so q/k/v are gathered over them) against the reference's
unsharded decode, as tests/test_spkv_decode.py holds the reference's own.
The ranks are spawned processes that import this module to find their
function, so the module imports jax and the reference inside its tests,
not at its top.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.kernels.paged_attention import ops as pt_ops
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.weights import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30
S_SHARD = 40                      # not a multiple of the kernel's 32-key tile
VALID = (0, 17, 44, 60, 80)       # absolute kv_valid of each row


def _case(sq, seed=0):
    rng = np.random.default_rng(seed)
    B, NKV, G, H = len(VALID), 2, 2, 32
    q = rng.standard_normal((B, sq, NKV * G, H)).astype(np.float32)
    k = rng.standard_normal((B, S_SHARD, NKV, H)).astype(np.float32)
    v = rng.standard_normal((B, S_SHARD, NKV, H)).astype(np.float32)
    valid = np.asarray(VALID, np.int32)
    pos = (np.maximum(valid - sq, 0)[:, None]
           + np.arange(sq)[None]).astype(np.int32)
    return q, k, v, pos, valid


def _has_key(pos, valid, off, NQ):
    """(B, NQ, Sq): whether a query has a valid key in the slice."""
    n = np.minimum(pos + 1, valid[:, None]) - off
    return np.broadcast_to((np.clip(n, 0, S_SHARD) > 0)[:, None],
                           (pos.shape[0], NQ, pos.shape[1]))


def _combine(parts):
    ms = np.stack([p[0] for p in parts])
    m = ms.max(0)
    corr = np.exp(ms - m[None])
    l = (np.stack([p[1] for p in parts]) * corr).sum(0)
    acc = (np.stack([p[2] for p in parts]) * corr[..., None]).sum(0)
    return acc / np.maximum(l, 1e-30)[..., None]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sq", [1, 8])
@pytest.mark.parametrize("off", [0, 40, 200], ids=["start", "mid", "past"])
def test_decode_partials_match_the_reference(off, sq, softcap):
    import jax.numpy as jnp
    from repro.kernels.paged_attention import ops as jax_ops
    q, k, v, pos, valid = _case(sq, seed=off + sq)
    if softcap:
        q = q * 30.0                # scores near the cap
    got = pt_ops.decode_partials(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(valid), kv_offset=off,
        softcap=softcap)
    want = jax_ops.decode_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(valid), kv_offset=jnp.asarray(off, jnp.int32),
        softcap=softcap)
    got = [t.numpy() for t in got]
    want = [np.asarray(t) for t in want]
    assert all(np.isfinite(t).all() for t in got)
    has = _has_key(pos, valid, off, q.shape[2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[has], w[has], **TOL)
    m, l, acc = got
    assert (m[~has] == NEG_INF).all() and (l[~has] == 0).all()
    assert (acc[~has] == 0).all()
    if off == 200:
        assert not has.any()        # the slice lies past every kv_valid
    # combined with the rest of the cache (a slice at 0 or at 40), the
    # outputs agree wherever a query has a key anywhere
    other = 40 if off == 0 else 0
    rest = [np.asarray(t) for t in jax_ops.decode_partials(
        jnp.asarray(q), jnp.asarray(np.roll(k, 1, 1)),
        jnp.asarray(np.roll(v, 1, 1)), jnp.asarray(pos), jnp.asarray(valid),
        kv_offset=jnp.asarray(other, jnp.int32), softcap=softcap)]
    any_key = has | _has_key(pos, valid, other, q.shape[2])
    np.testing.assert_allclose(_combine([got, rest])[any_key],
                               _combine([want, rest])[any_key], **TOL)


def test_decode_partials_take_a_per_row_offset():
    import jax.numpy as jnp
    from repro.kernels.paged_attention import ops as jax_ops
    q, k, v, pos, valid = _case(8, seed=3)
    offs = np.asarray([0, 0, 40, 40, 40], np.int32)
    got = pt_ops.decode_partials(
        *map(torch.from_numpy, (q, k, v, pos, valid)),
        kv_offset=torch.from_numpy(offs))
    want = jax_ops.decode_partials(*map(jnp.asarray, (q, k, v, pos, valid)),
                                   kv_offset=jnp.asarray(offs))
    has = np.stack([_has_key(pos[i:i + 1], valid[i:i + 1], offs[i],
                             q.shape[2])[0] for i in range(len(offs))])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[has], np.asarray(w)[has], **TOL)


# ---------------------------------------------------------------------------
# the SP-KV decode through the model on 2 ranks
# ---------------------------------------------------------------------------
ARCH, B, S_P, STEPS, MAX_LEN = "qwen3-1.7b", 4, 16, 4, 32


def _rank(rank, host, tokens):
    """One rank of a 1x2 mesh, with the heads whole and split: the
    prompt as one decode-mode step of 16 columns, then 4 one-column
    steps, every forward under the mesh's rules with the cache length
    over the model axis."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    return [_decode(mesh, host, tokens, split) for split in (False, True)]


def _decode(mesh, host, tokens, heads_split):
    from repro_torch.models.model import LM
    from repro_torch.parallel import axes as paxes
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.serve.engine import _local_zeros, mesh_layout

    model = LM(reduced_config(ARCH), device="cpu")
    rules = rules_for(model.cfg, mesh, sp_kv=True)
    if heads_split:
        rules.update(heads="model", kv_heads="model")
    whole = params_from_numpy(host, "cpu")
    lay = mesh_layout(model, whole, n_slots=B, max_len=MAX_LEN, spec_k=0,
                      mesh=mesh, rules=rules, sp_kv=True)
    params = paxes.shard_tree(whole, model.param_specs(), mesh, lay.rules)
    cache = _local_zeros(LM(model.cfg, device="meta").init_cache(
        B, MAX_LEN), lay.cache_specs, mesh, "cpu")
    toks = torch.from_numpy(tokens).long()
    out = []
    with paxes.sharding_ctx(mesh, lay.rules):
        pos = torch.arange(S_P)[None].expand(B, S_P)
        model.forward(params, toks[:, :S_P], pos, mode="decode", cache=cache)
        for t in range(S_P, S_P + STEPS):
            lg, cache = model.forward(params, toks[:, t:t + 1],
                                      torch.full((B, 1), t), mode="decode",
                                      cache=cache)
            out.append(lg.numpy())
    return (np.stack(out), tuple(params["stack"][0]["attn"]["wq"]["w"].shape),
            tuple(cache["k"].shape))


def test_spkv_decode_on_two_ranks_matches_the_reference():
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import build_model as ref_build_model
    cfg = ref_reduced_config(ARCH)
    ref = ref_build_model(cfg)
    params = ref.init_params(jax.random.key(0))
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (B, S_P + STEPS),
                                           0, cfg.vocab_size), np.int32)
    cache = ref.init_cache(B, MAX_LEN)
    pos = jnp.broadcast_to(jnp.arange(S_P)[None], (B, S_P))
    _, cache, _ = ref.forward(params, jnp.asarray(tokens[:, :S_P]), pos,
                              mode="prefill", cache=cache)
    want = []
    for t in range(S_P, S_P + STEPS):
        lg, cache, _ = ref.forward(params, jnp.asarray(tokens[:, t:t + 1]),
                                   jnp.full((B, 1), t, jnp.int32),
                                   mode="decode", cache=cache)
        want.append(np.asarray(lg))
    want = np.stack(want)
    host = jax.tree.map(np.asarray, params)
    H = cfg.resolved_head_dim
    res = spawn_ranks(_rank, 2, (host, tokens), device_type="cpu",
                      timeout=120, threads=1)
    for heads_split, by_rank in zip((False, True), zip(*res)):
        for got, wq_shape, k_shape in by_rank:
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
            # each rank holds half of the cache length, every KV head
            assert k_shape == (cfg.n_layers, B, MAX_LEN // 2, cfg.n_kv_heads,
                               H)
            assert wq_shape == (cfg.d_model, cfg.n_heads * H
                                // (2 if heads_split else 1))
