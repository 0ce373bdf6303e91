"""Sharded serving of the moe, ssm and hybrid families: the port's engine
on gloo CPU ranks against the reference's unsharded engine, and the
rank-local modules against the reference's functions.

The workload is tests/test_serve_sharded.py's: a page-aligned shared
prefix, six heavy requests that overrun a tight per-shard page budget
(shard-local preemption) and four light ones, 10 requests on 8 slots
(mid-run admission), the prefix cache asked for (the ssm and hybrid
cannot share a prefix: they warn and serve with the pool off on every
rank, as unsharded).  Each case's greedy tokens on every rank
equal the reference's unsharded engine's on the same weights, in fp32
on the reduced configs:

- mesh ``4`` (4 slot shards): phi3.5-moe and mamba2, the reference
  test's own cases;
- ``2x2``: phi3.5-moe (its 4 experts 2 a rank: expert-parallel),
  mamba2 (its 16 heads 8 a rank), jamba (both; the reduced config's
  attention is too small to split, so the rules leave ``heads`` whole
  and the mixer cuts its heads from those whole leaves), jamba with
  SP-KV (the attention cache's length over the model axis while the
  mamba sub-layers split heads), mamba2 with ``sp_kv=True`` (no
  attention: the rule is stripped, as the reference's ``rules_for``
  strips it, and nothing is recorded);
- ``1x4``: grok-1 reduced with 6 experts (6 % 4 != 0: each expert's d_ff
  split over the model axis, the ``expert_mlp`` fallback);
- ``1x2`` in int8: phi3.5-moe and jamba (each rank's q-packs through the
  int8 GEMM's plain version);
- ``1x2``: a phi3.5-moe checkpoint in the reference's format restored by
  ``restore_resharded`` (the blocks ``params_from_numpy(shard=)`` gives).

The modules, inside the 2-rank world, against the reference's on the
same numpy inputs: the rank-local ``moe_apply``, expert-parallel and
``expert_mlp``, fp32 within 1e-5 and int8 within 2e-4
(tests/test_quant.py's tolerance); the rank-local ``mamba_forward`` in
decode mode (a ragged chunk with ``n_valid`` 0, 1, partial and full,
then two single steps), ``y`` within 1e-5 and each rank's ``h`` and conv
window within 1e-5 of the reference's state at that rank's heads and
channels.  Two planted faults must fail those checks: the expert
combine's sum dropped, the gated norm's sum of squares dropped.

Every ranked engine runs with ``check=True`` and reports no error.  The
ranks are spawned processes (``launch.mesh.spawn_ranks``) that import
this module to find their function, so it imports jax and the reference
inside its fixtures; both worlds are module-scoped and shared.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.weights import params_from_numpy

PAGE = 8
WORLD_TIMEOUT_S = 150
TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=2e-4, atol=2e-4)
CKPT_STEP = 3

PHI, MAMBA, JAMBA, GROK = ("phi3.5-moe-42b-a6.6b", "mamba2-780m",
                           "jamba-v0.1-52b", "grok-1-314b")
# 6 experts on a 4-way model axis: the expert_mlp fallback
GROK_MOE = dict(num_experts=6, top_k=2, expert_d_ff=256,
                capacity_factor=6.0)
# name -> (arch, reduced-config overrides, int8)
MODELS = {"phi": (PHI, {}, False), "mamba": (MAMBA, {}, False),
          "jamba": (JAMBA, {}, False), "grok": (GROK, {"moe": GROK_MOE},
                                                False),
          "phi_int8": (PHI, {}, True), "jamba_int8": (JAMBA, {}, True)}


def config(arch, over):
    over = dict(over)
    if "moe" in over:
        over["moe"] = MoEConfig(**over["moe"])
    return reduced_config(arch, **over)


def workload(vocab, rng):
    shared = rng.integers(1, vocab, size=PAGE)
    reqs = []
    for i in range(6):
        tail = rng.integers(1, vocab, size=7)
        reqs.append((np.concatenate([shared, tail]), 5 if i % 2 else 4))
    for i in range(4):
        tail = rng.integers(1, vocab, size=4)
        reqs.append((np.concatenate([shared, tail]), 6))
    return reqs


ENGINE = dict(n_slots=8, max_len=32, page_size=PAGE, prefill_chunk=4,
              page_budget=16, prefix_cache=True)


def serve(model, params, **kw):
    eng = ContinuousBatchingEngine(model, params, **ENGINE, **kw)
    reqs = workload(model.cfg.vocab_size, np.random.default_rng(3))
    rids = [eng.submit(p, g) for p, g in reqs]
    out = eng.run()
    return eng, [out[r].tolist() for r in rids]


def _find(tree, key):
    """The first subtree under ``key`` in a parameter tree (the first
    layer's; a hybrid period's sub-layers in order), or None."""
    if isinstance(tree, list):
        tree = tree[0]
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree[key]
    for k in sorted(tree):
        got = _find(tree[k], key)
        if got is not None:
            return got
    return None


def _weight(p):
    """A projection's weight: a q-pack's ``q``, a dense pack's ``w``."""
    if isinstance(p, dict):
        return p["q"] if "q" in p else p["w"]
    return p


def _served(eng, toks):
    state = eng.cache.get("ssm", eng.cache)
    moe, mixer = (_find(eng.params["stack"], k) for k in ("moe", "mamba"))
    shapes = {}
    if moe is not None:
        shapes["gate"] = tuple(_weight(moe["gate"]).shape)
    if mixer is not None:
        shapes.update(wx=tuple(_weight(mixer["wx"]).shape),
                      wdt=tuple(_weight(mixer["wdt"]).shape),
                      conv_w=tuple(mixer["conv_w"].shape))
    return dict(
        tokens=toks, n_shards=eng.n_shards, meta=eng.sharding_meta,
        prefix_cache=eng.prefix_cache,
        rank_state=dict(eng._layout.rank_state),
        preemptions=sum(r.n_preemptions for r in eng.requests()),
        late=any(r.admit_step > 0 for r in eng.requests()),
        prefix_hits=eng.stats.prefix_hit_tokens,
        errors=[f.format() for f in eng.check_findings
                if f.severity == "error"],
        shapes=shapes,
        state={k: tuple(state[k].shape) for k in ("h", "conv")
               if k in state})


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------
def _rank(rank, cases, modules=None):
    """A rank's run of every serving case (each: a model of ``MODELS``,
    its numpy weights, a mesh spec, sp_kv, a checkpoint directory or
    None), in the same order on every rank, then the module checks."""
    import warnings
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.checkpoint.elastic import restore_resharded
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.tree import tree_leaves

    out = {}
    for name, (key, host, spec, sp_kv, ckpt) in cases.items():
        arch, over, _ = MODELS[key]
        mesh = mesh_lib.parse_mesh(spec, device="cpu")
        model = LM(config(arch, over), device="cpu")
        if ckpt is None:
            params = params_from_numpy(host, "cpu")
        else:
            rules = rules_for(model.cfg, mesh)
            specs = model.param_specs()
            params, _ = restore_resharded(Checkpointer(ckpt), CKPT_STEP,
                                          specs, mesh, rules)
            bridged = params_from_numpy(host, "cpu",
                                        shard=(specs, mesh, rules))
            out[name + "_bridge"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(bridged)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng, toks = serve(model, params, mesh=mesh, sp_kv=sp_kv,
                              check=True)
        out[name] = _served(eng, toks)
        out[name]["prefix_warned"] = any(
            "prefix_cache=True ignored" in str(w.message) for w in caught)
    if modules is not None:
        out["moe_apply"] = _moe_modules(modules["moe"])
        out["mamba_forward"] = {k: _mamba_module(v)
                                for k, v in modules["mamba"].items()}
    return out


def _moe_modules(case):
    """The rank-local ``moe_apply`` on a 1x2 mesh: expert-parallel (the
    rules') and ``expert_mlp`` (rules that split each expert's d_ff), in
    fp32 and int8; then expert-parallel with the combine's sum dropped."""
    from repro_torch.models import moe
    from repro_torch.models.quant import quantize_specs
    from repro_torch.parallel import axes as paxes
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.weights import tensor_from_numpy

    cfg = config(PHI, {})
    mesh = mesh_lib.parse_mesh("1x2", device="cpu")
    x = torch.from_numpy(case["x"])
    ep = rules_for(cfg, mesh)
    tp = dict(ep, expert=None, expert_mlp="model")
    out = {}
    for prec in ("fp32", "int8"):
        whole = _tree_to_torch(case[prec], tensor_from_numpy)
        specs = moe.moe_specs(cfg)
        if prec == "int8":
            specs = quantize_specs(specs, whole)
        for split, rules in (("ep", ep), ("tp", tp)):
            local = paxes.shard_tree(whole, specs, mesh, rules)
            with paxes.sharding_ctx(mesh, rules):
                y, _ = moe.moe_apply(local, x, cfg, with_aux=False)
            out[f"{prec}_{split}"] = y.numpy()
            out[f"{prec}_{split}_gate"] = tuple(_weight(local["gate"]).shape)
    local = paxes.shard_tree(_tree_to_torch(case["fp32"], tensor_from_numpy),
                             moe.moe_specs(cfg), mesh, ep)
    summed = moe._combine
    moe._combine = lambda y, axes: y
    try:
        with paxes.sharding_ctx(mesh, ep):
            out["fault"] = moe.moe_apply(local, x, cfg,
                                         with_aux=False)[0].numpy()
    finally:
        moe._combine = summed
    return out


def _mamba_module(case):
    """The rank-local ``mamba_forward`` in decode mode on a 1x2 mesh, from
    the rank's cut of a whole state: a ragged chunk, then two single
    steps; then the chunk again with the gated norm's sum dropped."""
    from repro_torch.models import mamba2
    from repro_torch.parallel import axes as paxes
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.weights import tensor_from_numpy

    cfg = config(case["arch"], {})
    mesh = mesh_lib.parse_mesh("1x2", device="cpu")
    rules = rules_for(cfg, mesh)
    whole = _tree_to_torch(case["params"], tensor_from_numpy)
    local = paxes.shard_tree(whole, mamba2.mamba_specs(cfg), mesh, rules)
    heads, chans = _held(cfg, mesh.coords["model"], 2)

    def state():
        return {"h": torch.from_numpy(case["h"][:, heads].copy()),
                "conv": torch.from_numpy(case["conv"][..., chans].copy())}

    st = state()
    ys = []
    with paxes.sharding_ctx(mesh, rules):
        for x, n_valid in case["steps"]:
            y, st = mamba2.mamba_forward(
                local, torch.from_numpy(x), cfg, state=st, mode="decode",
                n_valid=None if n_valid is None else torch.from_numpy(
                    n_valid))
            ys.append(y.numpy())
        summed = mamba2._norm_sumsq
        mamba2._norm_sumsq = lambda ss: ss
        try:
            x, n_valid = case["steps"][0]
            fault, _ = mamba2.mamba_forward(
                local, torch.from_numpy(x), cfg, state=state(),
                mode="decode", n_valid=torch.from_numpy(n_valid))
        finally:
            mamba2._norm_sumsq = summed
    return dict(ys=ys, h=st["h"].numpy(), conv=st["conv"].numpy(),
                fault=fault.numpy(), wdt=tuple(_weight(local["wdt"]).shape),
                wx=tuple(_weight(local["wx"]).shape))


def _held(cfg, index, n):
    """Rank ``index`` of ``n``'s heads and conv-window channels."""
    from repro_torch.models.mamba2 import dims
    s = cfg.ssm
    d_inner, nheads, conv_dim = dims(cfg)
    hl = nheads // n
    heads = np.arange(index * hl, (index + 1) * hl)
    chans = np.concatenate([np.arange(index * hl * s.head_dim,
                                      (index + 1) * hl * s.head_dim),
                            np.arange(d_inner, conv_dim)])
    return heads, chans


def _tree_to_torch(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, fn) for k, v in tree.items()}
    return fn(tree, "cpu")


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's unsharded engine's tokens on every model of
    ``MODELS`` with its numpy weights, a phi3.5-moe checkpoint in its
    format, and the module cases' inputs with the reference functions'
    outputs."""
    import warnings

    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.models import build_model as ref_build_model
    from repro.models import mamba2 as ref_mamba2
    from repro.models import moe as ref_moe
    from repro.models.quant import quantize_params
    from repro.serve import ContinuousBatchingEngine as RefEngine

    out = {"models": {}}
    for key, (arch, over, int8) in MODELS.items():
        cfg = config(arch, over)
        model = ref_build_model(cfg)
        params = model.init_params(jax.random.key(0))
        if key == "phi":
            ckpt = tmp_path_factory.mktemp("ckpt")
            JaxCheckpointer(str(ckpt)).save(CKPT_STEP, params)
            out["ckpt"] = str(ckpt)
        if int8:
            params = quantize_params(params)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng = RefEngine(model, params, **ENGINE)
        reqs = workload(cfg.vocab_size, np.random.default_rng(3))
        rids = [eng.submit(p, g) for p, g in reqs]
        res = eng.run()
        out["models"][key] = (jax.tree.map(np.asarray, params),
                              [res[r].tolist() for r in rids])

    # moe_apply: layer 0 of phi3.5-moe's tree, in fp32 and int8
    rng = np.random.default_rng(11)
    cfg = config(PHI, {})
    layer = {k: np.asarray(v[0]) for k, v in
             out["models"]["phi"][0]["stack"]["moe"].items()}
    q = jax.tree.map(np.asarray, quantize_params(
        {k: jnp.asarray(v) for k, v in layer.items()}))
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    moe_case = {"x": x, "fp32": layer, "int8": q}
    moe_want = {prec: np.asarray(ref_moe.moe_apply(
        jax.tree.map(jnp.asarray, moe_case[prec]), jnp.asarray(x), cfg)[0])
        for prec in ("fp32", "int8")}

    # mamba_forward: a mixer of jamba (its heads whole under the rules)
    # and of mamba2 (its heads split), from a random whole state
    mamba_cases, mamba_want = {}, {}
    for key, arch, index in (("jamba", JAMBA, 1), ("mamba", MAMBA, 0)):
        cfg = config(arch, {})
        stack = out["models"][key][0]["stack"]
        if key == "jamba":
            stack = stack[f"s{index}"]
        params = {k: np.asarray(v[0]) for k, v in stack["mamba"].items()}
        d_inner, nheads, conv_dim = ref_mamba2.dims(cfg)
        s = cfg.ssm
        B = 4
        h = (rng.standard_normal((B, nheads, s.head_dim, s.d_state))
             * 0.5).astype(np.float32)
        conv = (rng.standard_normal((B, s.conv_kernel - 1, conv_dim))
                * 0.5).astype(np.float32)

        def x_of(S):
            return (rng.standard_normal((B, S, cfg.d_model))
                    * 0.5).astype(np.float32)
        steps = [(x_of(5), np.asarray([0, 1, 3, 5], np.int32)),
                 (x_of(1), None), (x_of(1), None)]
        st = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        ys = []
        for xs, n_valid in steps:
            y, st = ref_mamba2.mamba_forward(
                jax.tree.map(jnp.asarray, params), jnp.asarray(xs), cfg,
                state=st, mode="decode",
                n_valid=None if n_valid is None else jnp.asarray(n_valid))
            ys.append(np.asarray(y))
        mamba_cases[key] = dict(arch=arch, params=params, h=h, conv=conv,
                                steps=steps)
        mamba_want[key] = dict(ys=ys, h=np.asarray(st["h"]),
                               conv=np.asarray(st["conv"]))
    out["modules"] = {"moe": moe_case, "mamba": mamba_cases}
    out["modules_want"] = {"moe": moe_want, "mamba": mamba_want}
    return out


def _world(reference, tmp_path, n, cases, modules=False):
    spec = {name: (key, reference["models"][key][0], mesh, sp_kv,
                   reference["ckpt"] if ckpt else None)
            for name, (key, mesh, sp_kv, ckpt) in cases.items()}
    return mesh_lib.spawn_ranks(
        _rank, n, (spec, reference["modules"] if modules else None),
        device_type="cpu", timeout=WORLD_TIMEOUT_S, threads=1,
        store_dir=str(tmp_path))


@pytest.fixture(scope="module")
def world4(reference, tmp_path_factory):
    return _world(reference, tmp_path_factory.mktemp("w4"), 4, {
        "phi_data4": ("phi", "4", False, False),
        "mamba_data4": ("mamba", "4", False, False),
        "phi_2x2": ("phi", "2x2", False, False),
        "mamba_2x2": ("mamba", "2x2", False, False),
        "jamba_2x2": ("jamba", "2x2", False, False),
        "jamba_spkv": ("jamba", "2x2", True, False),
        "mamba_spkv": ("mamba", "2x2", True, False),
        "grok_1x4": ("grok", "1x4", False, False)})


@pytest.fixture(scope="module")
def world2(reference, tmp_path_factory):
    return _world(reference, tmp_path_factory.mktemp("w2"), 2, {
        "phi_int8": ("phi_int8", "1x2", False, False),
        "jamba_int8": ("jamba_int8", "1x2", False, False),
        "phi_restored": ("phi", "1x2", False, True)}, modules=True)


def _same_everywhere(res, name, want):
    for rank, got in enumerate(res):
        case = got[name]
        assert case["tokens"] == want, f"rank {rank}: token divergence"
        assert not case["errors"], case["errors"]
    return res[0][name]


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,key", [("phi_data4", "phi"),
                                      ("mamba_data4", "mamba")])
def test_data_mesh_4_matches_the_reference(world4, reference, name, key):
    case = _same_everywhere(world4, name, reference["models"][key][1])
    assert case["n_shards"] == 4 and case["meta"]["mesh"] == {"data": 4}
    assert case["preemptions"] >= 1 and case["late"]
    assert (case["prefix_hits"] > 0) == (key == "phi")
    assert case["prefix_warned"] == (key == "mamba") != case["prefix_cache"]
    assert not case["rank_state"]


def test_moe_expert_parallel_on_2x2(world4, reference):
    case = _same_everywhere(world4, "phi_2x2", reference["models"]["phi"][1])
    cfg = reduced_config(PHI)
    assert case["meta"]["rules"]["expert"] == "model"
    assert case["prefix_hits"] > 0 and case["preemptions"] >= 1
    assert case["shapes"]["gate"] == (cfg.moe.num_experts // 2, cfg.d_model,
                                      cfg.moe.expert_d_ff)


@pytest.mark.parametrize("name,key", [("mamba_2x2", "mamba"),
                                      ("jamba_2x2", "jamba")])
def test_mixer_heads_on_2x2(world4, reference, name, key):
    """Each rank holds half the mixer's heads: ``h`` those heads, the
    conv window their x channels then B and C whole (``rank_state``),
    and the engine's mixer leaves match: the taps of those channels, and
    ``wdt`` those heads' columns also for jamba, whose ``heads`` leaves
    the rules leave whole (its reduced attention is too small to split)
    and the engine cuts once when it takes its blocks."""
    case = _same_everywhere(world4, name, reference["models"][key][1])
    assert case["prefix_warned"] and not case["prefix_cache"]
    cfg = reduced_config(MAMBA if key == "mamba" else JAMBA)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    held = d_inner // 2
    gn = s.ngroups * s.d_state
    assert case["shapes"]["wx"] == (cfg.d_model, held)
    n_mamba = cfg.n_layers if key == "mamba" else cfg.n_layers - 1
    assert case["state"]["h"] == (n_mamba, 4, held // s.head_dim,
                                  s.head_dim, gn)
    assert case["state"]["conv"] == (n_mamba, 4, s.conv_kernel - 1,
                                     held + 2 * gn)
    assert case["rank_state"] == case["state"]
    assert case["shapes"]["wdt"][1] == held // s.head_dim
    assert case["shapes"]["conv_w"] == (s.conv_kernel, held + 2 * gn)
    assert case["meta"]["rules"]["heads"] == (None if key == "jamba"
                                              else "model")


def test_hybrid_spkv_on_2x2(world4, reference):
    case = _same_everywhere(world4, "jamba_spkv",
                            reference["models"]["jamba"][1])
    assert case["meta"]["sp_kv"] and case["meta"]["rules"]["kv_seq"] == \
        "model"
    cfg = reduced_config(JAMBA)
    assert case["state"]["h"][2] == (cfg.ssm.expand * cfg.d_model
                                     // cfg.ssm.head_dim // 2)


def test_ssm_spkv_is_stripped(world4, reference):
    case = _same_everywhere(world4, "mamba_spkv",
                            reference["models"]["mamba"][1])
    assert not case["meta"]["sp_kv"]
    assert case["meta"]["rules"]["kv_seq"] is None
    assert not case["meta"]["forced_replication"]


def test_expert_mlp_fallback_on_1x4(world4, reference):
    case = _same_everywhere(world4, "grok_1x4", reference["models"]["grok"][1])
    assert case["meta"]["rules"]["expert"] is None
    assert case["meta"]["rules"]["expert_mlp"] == "model"
    assert case["shapes"]["gate"] == (6, 128, 256 // 4)


@pytest.mark.parametrize("key", ["phi_int8", "jamba_int8"])
def test_int8_on_1x2(world2, reference, key):
    case = _same_everywhere(world2, key, reference["models"][key][1])
    assert case["shapes"]["gate"][0] == reduced_config(
        MODELS[key][0]).moe.num_experts // 2


def test_restored_checkpoint_serves_on_1x2(world2, reference):
    """A reference checkpoint restored by ``restore_resharded`` gives each
    rank the blocks ``params_from_numpy(shard=)`` gives from the numpy
    tree, and serves the reference's tokens."""
    _same_everywhere(world2, "phi_restored", reference["models"]["phi"][1])
    assert all(r["phi_restored_bridge"] for r in world2)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prec,split", [("fp32", "ep"), ("fp32", "tp"),
                                        ("int8", "ep"), ("int8", "tp")])
def test_rank_local_moe_apply(world2, reference, prec, split):
    want = reference["modules_want"]["moe"][prec]
    tol = TOL if prec == "fp32" else INT8_TOL
    cfg = reduced_config(PHI)
    E, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
    for rank in world2:
        got = rank["moe_apply"]
        np.testing.assert_allclose(got[f"{prec}_{split}"], want, **tol)
        assert got[f"{prec}_{split}_gate"] == (
            (E // 2, cfg.d_model, f) if split == "ep"
            else (E, cfg.d_model, f // 2))


@pytest.mark.parametrize("key", ["mamba", "jamba"])
def test_rank_local_mamba_decode(world2, reference, key):
    want = reference["modules_want"]["mamba"][key]
    cfg = reduced_config(MAMBA if key == "mamba" else JAMBA)
    for index, rank in enumerate(world2):
        got = rank["mamba_forward"][key]
        for step, (a, b) in enumerate(zip(got["ys"], want["ys"])):
            np.testing.assert_allclose(a, b, **TOL,
                                       err_msg=f"rank {index} step {step}")
        heads, chans = _held(cfg, index, 2)
        np.testing.assert_allclose(got["h"], want["h"][:, heads], **TOL)
        np.testing.assert_allclose(got["conv"], want["conv"][..., chans],
                                   **TOL)
        assert got["wx"][1] == cfg.ssm.expand * cfg.d_model // 2


def _outside(got, want, tol):
    return not np.allclose(got, want, **tol)


def test_planted_faults_are_caught(world2, reference):
    """The expert combine's sum dropped (each rank keeps only its
    experts' share) and the gated norm's sum of squares dropped (each row
    normalised by half of d_inner) both fall outside the tolerance."""
    for rank in world2:
        assert _outside(rank["moe_apply"]["fault"],
                        reference["modules_want"]["moe"]["fp32"], TOL)
        for key in ("mamba", "jamba"):
            assert _outside(rank["mamba_forward"][key]["fault"],
                            reference["modules_want"]["mamba"][key]["ys"][0],
                            TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_serves_jamba_int8_on_1x2():
    argv = ["--arch", JAMBA, "--reduced", "--device", "cpu", "--int8",
            "--slots", "2", "--requests", "3", "--prompt-len", "12",
            "--gen-len", "4"]
    base = launch_serve.main(argv)
    res = launch_serve.main(argv + ["--mesh", "1x2"])
    assert res["mesh"]["mesh"] == {"data": 1, "model": 2}
    assert max(res["rank_param_bytes"]) < base["param_bytes"]
    assert sorted(res["tokens"]) == sorted(base["tokens"])
    for rid, toks in base["tokens"].items():
        np.testing.assert_array_equal(res["tokens"][rid], toks)


# ---------------------------------------------------------------------------
# the layout (no ranks: the resolver reads only the mesh's shape)
# ---------------------------------------------------------------------------
def _layout(cfg, dims, **rules):
    """``mesh_layout`` of ``cfg`` over a mesh of ``dims`` (a duck: its
    shape only), under ``rules_for``'s rules updated by ``rules``."""
    import types
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.serve.engine import mesh_layout
    mesh = types.SimpleNamespace(shape=dict(zip(
        mesh_lib.AXIS_NAMES[len(dims)], dims)))
    model = LM(cfg, device="meta")
    lay = mesh_layout(model, model.init_params(None), n_slots=8,
                      max_len=256, spec_k=0, mesh=mesh,
                      rules=dict(rules_for(cfg, mesh), **rules),
                      sp_kv=False)
    return lay, mesh


def test_rank_state_and_layout_refusals():
    """A rank's recurrent state at full width (mamba2-780m on 1x2: 24 of
    48 heads, the window's 1536 x channels then B and C's 256), and the
    mixer layouts the rank-local mixer refuses: a ``d_inner`` block that
    is not whole heads, ``heads`` split apart from ``mlp``; and the sums
    that would add other slots' tokens: the experts or the mixer's
    ``d_inner`` split over a batch axis, the experts and each expert's
    d_ff both split."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import check_layout

    cfg = get_config(MAMBA, n_layers=2)
    lay, mesh = _layout(cfg, (1, 2))
    check_layout(cfg, lay, mesh)
    assert lay.rank_state == {"h": (2, 8, 24, 64, 128),
                              "conv": (2, 8, 3, 1536 + 256)}
    assert _layout(cfg, (2, 1))[0].rank_state == {}
    small = reduced_config(MAMBA)             # 16 heads of 16 channels
    phi = reduced_config(PHI)
    for c, dims, rules, match in (
            (small, (1, 32), {}, "not whole heads"),
            (small, (2, 2), {"heads": "data"}, "apart"),
            (small, (2, 2), {"heads": "data", "mlp": "data"},
             "'mlp' split .* cut the slots"),
            (phi, (2, 2), {"expert": "data"},
             "'expert' split .* cut the slots"),
            (phi, (2, 2), {"expert_mlp": "data"}, "one of the two")):
        lay, mesh = _layout(c, dims, **rules)
        with pytest.raises(NotImplementedError, match=match):
            check_layout(c, lay, mesh)
