"""Sharded serving: the port's engine on gloo CPU ranks against the
reference's unsharded engine, the cases of tests/test_serve_sharded.py.

The workload is the reference test's: a page-aligned shared prefix, six
heavy requests that overrun a tight per-shard page budget (shard-local
preemption) and four light ones, 10 requests on 8 slots (mid-run
admission), the prefix cache on.  Each case's greedy tokens on every
rank equal the reference's unsharded engine's on the same weights (the
reference's own tests show its sharded engine gives those):

- mesh ``4`` (data: 4 slot shards), granite reduced;
- ``2x2`` with SP-KV (2 slot shards, the cache length over the model
  axis), granite and qwen3 reduced;
- ``1x3`` with SP-KV asked for: 32 % 3, so the rule is stripped and the
  decision recorded;
- ``1x2`` in int8 (each rank's q-packs), and qwen3 with its heads split
  over the model axis (column- and row-parallel attention); granite's
  one KV head cannot split and is refused;
- mesh ``"1"`` and a one-position mesh: bitwise the unmeshed engine;
- ``python -m repro_torch.launch.serve --mesh 2x2 --sp-kv``.

Every ranked engine runs with ``check=True`` (the host-only shadow
checker) and reports no error.  The ranks are spawned processes
(``launch.mesh.spawn_ranks``: a FileStore under the test's tmp_path, a
60 s timeout on every process group and 120 s on the whole world), which
import this module to find their function, so it imports jax and the
reference inside its fixtures.
"""
import numpy as np
import pytest

from repro_torch.configs import reduced_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import LM
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy

PAGE = 8
WORLD_TIMEOUT_S = 120


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


def serve(model, params, reqs, **kw):
    eng = ContinuousBatchingEngine(
        model, params, n_slots=8, max_len=32, page_size=PAGE,
        prefill_chunk=4, page_budget=16, prefix_cache=True, **kw)
    rids = [eng.submit(p, g) for p, g in reqs]
    out = eng.run()
    return eng, [out[r].tolist() for r in rids]


def _serve_cases(rank, cases):
    """A rank's run of every case (each case: arch, numpy weights, mesh
    spec, sp_kv, extra rules); the same cases in the same order on every
    rank, as their process groups need."""
    from repro_torch.parallel.sharding import rules_for
    out = {}
    for name, (arch, host, spec, sp_kv, extra_rules) in cases.items():
        mesh = mesh_lib.parse_mesh(spec, device="cpu")
        model = LM(reduced_config(arch), device="cpu")
        rules = None
        if extra_rules:
            rules = dict(rules_for(model.cfg, mesh, sp_kv=sp_kv),
                         **extra_rules)
        try:
            eng, toks = serve(model, params_from_numpy(host, "cpu"),
                              workload(model.cfg.vocab_size,
                                       np.random.default_rng(3)),
                              mesh=mesh, rules=rules, sp_kv=sp_kv, check=True)
        except NotImplementedError as e:
            out[name] = str(e)
            continue
        out[name] = dict(
            tokens=toks, n_shards=eng.n_shards, meta=eng.sharding_meta,
            preemptions=sum(r.n_preemptions for r in eng.requests()),
            late=any(r.admit_step > 0 for r in eng.requests()),
            prefix_hits=eng.stats.prefix_hit_tokens,
            errors=[f.format() for f in eng.check_findings
                    if f.severity == "error"],
            param_shapes=[tuple(t.shape) for t in (
                eng.params["embed"]["table"]["q"]
                if isinstance(eng.params["embed"]["table"], dict)
                else eng.params["embed"]["table"],
                eng.params["stack"][0]["attn"]["wq"]["w"]
                if "w" in eng.params["stack"][0]["attn"]["wq"]
                else eng.params["stack"][0]["attn"]["wq"]["q"],
                eng.params["stack"][0]["mlp"]["down"].get(
                    "w", eng.params["stack"][0]["mlp"]["down"].get("q")),
                eng.cache["k"])])
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's unsharded engine's tokens and its numpy weights:
    granite and qwen3 reduced in fp32, granite's int8 tree."""
    import jax
    from repro.configs import reduced_config as ref_reduced_config
    from repro.models import build_model as ref_build_model
    from repro.models.quant import quantize_params
    from repro.serve import ContinuousBatchingEngine as RefEngine

    out = {}
    for name, arch, int8 in (("granite", "granite-3-2b", False),
                             ("qwen3", "qwen3-1.7b", False),
                             ("int8", "granite-3-2b", True)):
        cfg = ref_reduced_config(arch)
        model = ref_build_model(cfg)
        params = model.init_params(jax.random.key(0))
        if int8:
            params = quantize_params(params)
        eng = RefEngine(model, params, n_slots=8, max_len=32,
                        page_size=PAGE, prefill_chunk=4, page_budget=16,
                        prefix_cache=True)
        reqs = workload(cfg.vocab_size, np.random.default_rng(3))
        rids = [eng.submit(p, g) for p, g in reqs]
        res = eng.run()
        out[name] = (arch, jax.tree.map(np.asarray, params),
                     [res[r].tolist() for r in rids])
    return out


def _world(reference, tmp_path, n, cases):
    spec = {name: (reference[ref][0], reference[ref][1], mesh, sp_kv, rules)
            for name, (ref, mesh, sp_kv, rules) in cases.items()}
    return mesh_lib.spawn_ranks(_serve_cases, n, (spec,), device_type="cpu",
                                timeout=WORLD_TIMEOUT_S, threads=1,
                                store_dir=str(tmp_path))


@pytest.fixture(scope="module")
def world4(reference, tmp_path_factory):
    return _world(reference, tmp_path_factory.mktemp("w4"), 4, {
        "data4": ("granite", "4", False, None),
        "spkv_granite": ("granite", "2x2", True, None),
        "spkv_qwen3": ("qwen3", "2x2", True, None)})


@pytest.fixture(scope="module")
def world2(reference, tmp_path_factory):
    heads = {"heads": "model", "kv_heads": "model"}
    return _world(reference, tmp_path_factory.mktemp("w2"), 2, {
        "int8": ("int8", "1x2", False, None),
        "qwen3_heads": ("qwen3", "1x2", False, heads),
        "granite_heads": ("granite", "1x2", False, heads)})


def _same_everywhere(res, name, want):
    for rank, got in enumerate(res):
        case = got[name]
        assert case["tokens"] == want, f"rank {rank}: token divergence"
        assert not case["errors"], case["errors"]
    return res[0][name]


def test_data_mesh_4_matches_the_reference(world4, reference):
    case = _same_everywhere(world4, "data4", reference["granite"][2])
    assert case["n_shards"] == 4
    assert case["preemptions"] >= 1 and case["late"]
    assert case["prefix_hits"] > 0
    assert case["meta"]["mesh"] == {"data": 4}
    assert not case["meta"]["sp_kv"]


@pytest.mark.parametrize("name,ref", [("spkv_granite", "granite"),
                                      ("spkv_qwen3", "qwen3")])
def test_spkv_2x2_matches_the_reference(world4, reference, name, ref):
    case = _same_everywhere(world4, name, reference[ref][2])
    assert case["n_shards"] == 2 and case["meta"]["sp_kv"]
    assert case["meta"]["rules"]["kv_seq"] == "model"
    assert case["prefix_hits"] > 0
    # each rank holds half the cache length, half the vocab and the MLP
    embed, _, down, k = case["param_shapes"]
    cfg = reduced_config(reference[ref][0])
    assert k == (cfg.n_layers, 4, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert embed[0] == cfg.padded_vocab // 2 and down[0] == cfg.d_ff // 2


def test_spkv_1x3_is_stripped_and_recorded(reference, tmp_path):
    res = _world(reference, tmp_path, 3,
                 {"spkv_1x3": ("granite", "1x3", True, None)})
    case = _same_everywhere(res, "spkv_1x3", reference["granite"][2])
    assert not case["meta"]["sp_kv"]
    assert any("sp_kv disabled" in d
               for d in case["meta"]["forced_replication"])


def test_int8_on_1x2_matches_the_reference(world2, reference):
    case = _same_everywhere(world2, "int8", reference["int8"][2])
    embed, _, down, _ = case["param_shapes"]
    cfg = reduced_config("granite-3-2b")
    assert embed[0] == cfg.padded_vocab // 2 and down[0] == cfg.d_ff // 2


def test_split_heads_on_1x2(world2, reference):
    """qwen3's 4 query / 2 KV heads split over the model axis (rules that
    map them there): whole heads and GQA groups on each rank, tokens the
    reference's.  granite's one KV head would be cut: refused."""
    case = _same_everywhere(world2, "qwen3_heads", reference["qwen3"][2])
    cfg = reduced_config("qwen3-1.7b")
    _, wq, _, k = case["param_shapes"]
    assert wq == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim // 2)
    assert k[3] == cfg.n_kv_heads // 2
    for rank in world2:
        assert "cut a head" in rank["granite_heads"]


def test_one_position_mesh_is_the_unmeshed_engine(reference):
    """``parse_mesh("1")`` is no mesh, and a mesh of one position serves
    bit for bit as the unmeshed engine (and records its layout)."""
    arch, host, want = reference["granite"]
    model = LM(reduced_config(arch), device="cpu")
    params = params_from_numpy(host, "cpu")
    reqs = workload(model.cfg.vocab_size, np.random.default_rng(3))
    assert mesh_lib.parse_mesh("1") is None
    _, base = serve(model, params, reqs)
    one = mesh_lib.make_mesh((1,), ("data",), device="cpu")
    eng, got = serve(model, params, reqs, mesh=one, sp_kv=True)
    assert base == got == want
    assert eng.n_shards == 1 and not eng.sharding_meta["sp_kv"]
    for a, b in zip(tree_leaves(params), tree_leaves(eng.params)):
        assert a is b            # nothing was cut or copied


def test_launcher_serves_on_a_2x2_mesh():
    argv = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
            "--slots", "4", "--requests", "6", "--prompt-len", "16",
            "--gen-len", "5"]
    base = launch_serve.main(argv)
    res = launch_serve.main(argv + ["--mesh", "2x2", "--sp-kv"])
    assert res["mesh"]["mesh"] == {"data": 2, "model": 2}
    assert res["mesh"]["sp_kv"] and len(res["rank_param_bytes"]) == 4
    assert max(res["rank_param_bytes"]) < res["init_param_bytes"]
    assert sorted(res["tokens"]) == sorted(base["tokens"])
    for rid, toks in base["tokens"].items():
        np.testing.assert_array_equal(res["tokens"][rid], toks)


def test_launcher_refusals():
    argv = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit, match="model axis"):
        launch_serve.main(argv + ["--mesh", "2", "--sp-kv"])
    with pytest.raises(ValueError, match="static"):
        launch_serve.main(argv + ["--mesh", "2", "--static"])
    for flag in (["--open-loop", "--clock", "model"], ["--speculative"]):
        with pytest.raises(NotImplementedError, match="A10"):
            launch_serve.main(argv + ["--mesh", "2"] + flag)
    with pytest.raises(ValueError, match="bad mesh spec"):
        launch_serve.main(argv + ["--mesh", "2y2"])
    # the vlm and audio families are not served under a mesh yet
    for arch in ("whisper-base", "llama-3.2-vision-90b"):
        with pytest.raises(NotImplementedError, match="A10"):
            launch_serve.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--mesh", "2"])
