"""The port's sharding layout against the reference, with no ranks at all.

The reference's ``resolve_spec``, ``rules_for`` and ``layout_report``
read only ``mesh.shape``, so both packages resolve over a duck-typed mesh
(``SimpleNamespace(shape=...)``): for every config and mesh, with SP-KV
off and on, each leaf of the port's ``param_specs``, ``quantize_specs``
and ``cache_specs`` resolves to the reference's spec of its counterpart
(the weight bridge's leaf map: a port layer ``stack[i]`` is the
reference's stacked leaf without its leading axis), with the same
forced-replication decisions, string for string; and the engine's whole
layout (``serve.engine.mesh_layout``) gives the reference engine's
``sharding_meta`` (its own ``_init_mesh_layout``, run with the device
puts stubbed).  Then ``parse_mesh``'s grammar and refusals, the blocks
``local_slice`` cuts, an elastic restore of a JAX checkpoint onto a
mesh, and the collectives on four gloo CPU ranks."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.launch import mesh as ref_mesh
from repro.models import build_model as ref_build_model
from repro.models.quant import quantize_params as ref_quantize_params
from repro.models.quant import quantize_specs as ref_quantize_specs
from repro.parallel import axes as ref_axes
from repro.parallel import sharding as ref_sharding
from repro.serve import engine as ref_engine

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import restore_resharded
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.model import LM
from repro_torch.models.quant import quantize_specs
from repro_torch.parallel import axes as paxes
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import layout_report, rules_for
from repro_torch.serve.engine import mesh_layout
from repro_torch.weights import params_from_numpy

MESHES = ((2,), (1, 2), (2, 2), (1, 3), (4, 4), (16, 16), (2, 16, 16))
N_SLOTS, MAX_LEN = 8, 512


def duck(dims):
    names = port_mesh.AXIS_NAMES[len(dims)]
    return types.SimpleNamespace(shape=dict(zip(names, dims)))


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference model, its param / cache / int8 param shape trees, port
    model, its meta param / cache trees) at full width."""
    ref = ref_build_model(ref_get_config(arch))
    ref_p = jax.eval_shape(lambda: ref.init_params(jax.random.key(0)))
    ref_c = jax.eval_shape(lambda: ref.init_cache(N_SLOTS, MAX_LEN))
    ref_q = jax.eval_shape(
        lambda: ref_quantize_params(ref.init_params(jax.random.key(0))))
    port = LM(get_config(arch), device="meta")
    return (ref, ref_p, ref_c, ref_q, port, port.init_params(None),
            port.init_cache(N_SLOTS, MAX_LEN))


def ref_leaf(tree, path):
    """The reference's counterpart of a port leaf: ``stack[i]`` -> the
    stacked ``stack``."""
    node = tree
    for key in path:
        if not isinstance(key, int):
            node = node[key]
    return node


def port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from port_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from port_leaves(t, path + (i,))
    else:
        yield path, tree


def full_spec(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def trailing(shape, r_shape):
    """How many of the port leaf's dims lead (stacked layers, merged in
    the port where the reference keeps (periods, sub-layers)): the rest
    are the reference's trailing dims.  A port layer of a stack list has
    none: the reference's leading layer dim is the list."""
    for k in range(len(shape) + 1):
        rest = len(shape) - k
        if (r_shape[len(r_shape) - rest:] == shape[k:]
                and (k == 0 or np.prod(r_shape[:len(r_shape) - rest])
                     == np.prod(shape[:k]))):
            return k
    raise AssertionError(f"{shape} is no stacking of {r_shape}")


def aligned(port_spec, shape, ref_spec, r_shape):
    """Both resolved specs over their common trailing dims; the stacked
    dims before them must be whole in both."""
    k = trailing(shape, r_shape)
    p, r = full_spec(port_spec, len(shape)), full_spec(ref_spec,
                                                       len(r_shape))
    rest = len(shape) - k
    lead = p[:k] + r[:len(r_shape) - rest]
    assert all(e is None for e in lead), (port_spec, ref_spec)
    return p[k:], r[len(r_shape) - rest:]


def resolve_both(port_logical, port_shape, ref_logical, ref_shape, mesh,
                 rules):
    with paxes.sharding_ctx(mesh, rules):
        p = paxes.resolve_spec(port_logical, port_shape)
        pd = paxes.decisions()
    with ref_axes.sharding_ctx(mesh, rules):
        r = ref_axes.resolve_spec(ref_logical, ref_shape)
        rd = ref_axes.decisions()
    return p, pd, r, rd


def check_tree(port_specs, port_shapes, ref_specs, ref_shapes, mesh, rules,
               ref_path_of=lambda path: path):
    n = 0
    for path, logical in port_leaves(port_specs):
        node = port_shapes
        for key in path:
            node = node[key]
        shape = tuple(node.shape)
        rpath = ref_path_of(path)
        r_logical = ref_leaf(ref_specs, rpath)
        r_node = ref_leaf(ref_shapes, rpath)
        r_shape = tuple(r_node.shape)
        p, pd, r, rd = resolve_both(logical, shape, r_logical, r_shape,
                                    mesh, rules)
        pa, ra = aligned(p, shape, r, r_shape)
        assert pa == ra, (path, p, r)
        assert pd == rd, (path, pd, rd)
        n += 1
    return n


def qshapes(tree):
    """The port's int8 tree's shapes, from its float tree (what
    ``quantize_params`` makes of each weight)."""
    from repro_torch.models.quant import _MAMBA_KEYS, _MOE_KEYS

    def pack(w, table=False):
        scale = (w.shape[0],) if table else w.shape[:-2] + w.shape[-1:]
        return {"q": w, "scale": torch.empty(scale, device="meta")}

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return t
        if set(t) == {"w"} and t["w"].dim() == 2:
            return pack(t["w"])
        if set(t) == {"table"}:
            return {"table": pack(t["table"], table=True)}
        def packed(k, v):
            return torch.is_tensor(v) and (
                (k in _MOE_KEYS and v.dim() == 3)
                or (k in _MAMBA_KEYS and "A_log" in t and v.dim() == 2))
        return {k: pack(v) if packed(k, v) else walk(v)
                for k, v in t.items()}
    return walk(tree)


CACHE_ROOT = {"dense": ("layers",), "moe": ("layers",), "ssm": ("layers",),
              "audio": ("layers",), "hybrid": ("periods",),
              "vlm": ("periods",)}


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_resolve_as_the_reference(arch, dims):
    ref, ref_p, ref_c, ref_q, port, port_p, port_c = trees(arch)
    mesh = duck(dims)
    for sp_kv in (False, True):
        rules = rules_for(port.cfg, mesh, sp_kv=sp_kv)
        assert rules == ref_sharding.rules_for(ref.cfg, mesh, sp_kv=sp_kv)
        specs = port.param_specs()
        n = check_tree(specs, port_p, ref.param_specs(), ref_p, mesh, rules)
        assert n == sum(1 for _ in port_leaves(port_p))
        qspecs = quantize_specs(specs, port_p)
        ref_qspecs = ref_quantize_specs(ref.param_specs(), ref_p)
        check_tree(qspecs, qshapes(port_p), ref_qspecs, ref_q, mesh, rules)
        root = CACHE_ROOT[port.cfg.family]
        check_tree(port.cache_specs(), port_c, ref.cache_specs(), ref_c,
                   mesh, rules, ref_path_of=lambda p: root + p)


@pytest.fixture
def ref_layout_stubs(monkeypatch):
    """The reference engine's ``_init_mesh_layout`` over a duck mesh:
    its ``NamedSharding`` and ``device_put`` stubbed to pass specs and
    trees through."""
    monkeypatch.setattr(ref_axes, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_engine.jax, "device_put", lambda x, s=None: x)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_engine_layout_is_the_reference_engines(arch, dims,
                                                ref_layout_stubs):
    ref, ref_p, _, _, port, port_p, _ = trees(arch)
    mesh = duck(dims)
    for sp_kv in (False, True):
        fake = types.SimpleNamespace(
            model=ref, mesh=mesh, sp_kv=sp_kv, n_slots=N_SLOTS,
            max_len=MAX_LEN, spec_k=0, params=ref_p,
            rules=ref_sharding.rules_for(ref.cfg, mesh, sp_kv=sp_kv))
        ref_engine.ContinuousBatchingEngine._init_mesh_layout(fake)
        lay = mesh_layout(port, port_p, n_slots=N_SLOTS, max_len=MAX_LEN,
                          spec_k=0, mesh=mesh,
                          rules=rules_for(port.cfg, mesh, sp_kv=sp_kv),
                          sp_kv=sp_kv)
        got = layout_report(mesh, lay.rules, lay.decisions,
                            n_shards=lay.n_shards, sp_kv=lay.sp_kv)
        assert got == fake.sharding_meta
        assert lay.n_shards == fake.n_shards


PARSE_SPECS = (None, "", "none", "NONE", "1", "2", "2x2", "1x3", "4x4",
               "2x16x16", "1x1", "x", "2x", "0", "2x0", "1x2x3x4", "a",
               "-1")


def _outcome(fn, spec):
    try:
        out = fn(spec)
    except ValueError:
        return "ValueError"
    return out


@pytest.mark.parametrize("spec", PARSE_SPECS, ids=repr)
def test_parse_mesh_grammar_is_the_references(spec, monkeypatch):
    """The grammar (axis names by rank, ``None`` for the no-op specs,
    ``ValueError`` for bad ones) is the reference's; where the
    reference's mesh needs more devices than it has, the port's needs a
    world of its size, and both refuse (``RuntimeError``)."""
    monkeypatch.setattr(ref_mesh, "make_mesh",
                        lambda dims, names, **kw: (tuple(dims), tuple(names)))
    monkeypatch.setattr(ref_mesh.jax, "devices", lambda: [None] * 1024)
    assert (_outcome(port_mesh.parse_mesh_dims, spec)
            == _outcome(ref_mesh.parse_mesh, spec))
    monkeypatch.undo()
    parsed = port_mesh.parse_mesh_dims(spec) if _outcome(
        port_mesh.parse_mesh_dims, spec) != "ValueError" else "bad"
    if parsed in (None, "bad"):
        return
    if np.prod(parsed[0]) == 1:
        mesh = port_mesh.parse_mesh(spec, device="cpu")
        assert mesh.shape == dict(zip(parsed[1], parsed[0]))
        assert mesh.backend is None and mesh.rank == 0
        return
    with pytest.raises(RuntimeError, match="world"):
        port_mesh.parse_mesh(spec, device="cpu")
    with pytest.raises(RuntimeError):
        ref_mesh.parse_mesh(spec)


@pytest.mark.parametrize("dims,spec", [
    ((2, 2), ("data", "model")), ((2, 3), (None, "model")),
    ((2, 2, 2), (("pod", "data"), "model")), ((2, 2, 2), ("model",)),
    ((4,), ("data", None))])
def test_local_blocks_tile_the_tensor(dims, spec):
    """Every rank's ``local_slice`` is its contiguous block (the
    reference's ``NamedSharding`` layout: a tuple entry's first axis the
    major one), ``local_shape`` its shape, and the blocks tile the
    tensor."""
    names = port_mesh.AXIS_NAMES[len(dims)]
    x = np.arange(8 * 12).reshape(8, 12)
    seen = np.zeros_like(x)
    for rank in range(int(np.prod(dims))):
        mesh = port_mesh.Mesh(dims, names, rank=rank, device="cpu")
        block = paxes.local_slice(x, paxes.PartitionSpec(*spec), mesh)
        assert block.shape == paxes.local_shape(x.shape, spec, mesh)
        index = []
        for d, entry in enumerate(spec):
            axes = paxes.entry_axes(entry)
            n = int(np.prod([mesh.shape[a] for a in axes]))
            i = 0
            for a in axes:
                i = i * mesh.shape[a] + mesh.coords[a]
            size = x.shape[d] // n
            index.append(slice(i * size, (i + 1) * size))
        np.testing.assert_array_equal(block, x[tuple(index)])
        seen[tuple(index)] += 1
    replicas = int(np.prod(dims)) // int(np.prod(
        [np.prod([dict(zip(names, dims))[a] for a in paxes.entry_axes(e)])
         for e in spec]))
    assert (seen == replicas).all()


def test_elastic_restore_reads_each_ranks_blocks(tmp_path):
    """A checkpoint written by the reference's checkpointer, restored on
    each rank of a 1x2 mesh: each rank gets exactly its blocks of the
    whole tree (``shard_tree`` of it), as ``params_from_numpy(shard=)``
    gives them from the numpy tree."""
    cfg = ref_reduced_config("granite-3-2b")
    ref = ref_build_model(cfg)
    params = ref.init_params(jax.random.key(0))
    JaxCheckpointer(str(tmp_path)).save(3, params)
    host = jax.tree.map(np.asarray, params)
    model = LM(reduced_config("granite-3-2b"), device="cpu")
    whole = params_from_numpy(host, "cpu")
    specs = model.param_specs()
    for rank in range(2):
        mesh = port_mesh.Mesh((1, 2), ("data", "model"), rank=rank,
                              device="cpu")
        rules = rules_for(model.cfg, mesh)
        got, manifest = restore_resharded(Checkpointer(str(tmp_path)), 3,
                                          specs, mesh, rules)
        assert manifest["step"] == 3
        want = paxes.shard_tree(whole, specs, mesh, rules)
        bridged = params_from_numpy(host, "cpu", shard=(specs, mesh, rules))
        for a, b, c in zip(port_leaves(got), port_leaves(want),
                           port_leaves(bridged)):
            assert a[0] == b[0] == c[0]
            assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])
        # the MLP and the vocabulary are split over the model axis
        assert got["embed"]["table"].shape[0] == cfg.padded_vocab // 2
        assert got["stack"][0]["mlp"]["down"]["w"].shape[0] == cfg.d_ff // 2


def _block(rank):
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank


def _collectives_rank(rank):
    """One rank of ``make_host_mesh(model=2)`` over four: each collective
    on this rank's block (``_block``)."""
    mesh = port_mesh.make_host_mesh(model=2, device="cpu")
    x = _block(rank)
    with paxes.sharding_ctx(mesh):
        shaped = paxes.constrain(x, "batch", "embed")
        with pytest.raises(ValueError, match="2 axes for rank-3"):
            paxes.constrain(x[None], "batch", "embed")
    return dict(
        shape=mesh.shape, rank_at=mesh.rank_at(("model",), 1),
        sum=collectives.all_reduce_sum(x.clone(), ("model",), mesh),
        max=collectives.all_reduce_max(x.clone(), ("data",), mesh),
        gather=collectives.all_gather(x, 1, ("data", "model"), mesh),
        bcast=collectives.broadcast(x.clone(), ("model",), 1, mesh),
        constrained=shaped is x)


def test_collectives_on_four_gloo_ranks():
    """A 2x2 mesh of four CPU ranks: the sum over ``model`` of the two
    ranks of a data row, the maximum over ``data``, the gather of all
    four blocks in rank order, the broadcast of each row's model-rank 1;
    ``constrain`` is the identity and checks the rank.  A one-position
    mesh needs no process group and every collective returns its
    input."""
    res = port_mesh.spawn_ranks(_collectives_rank, 4, device_type="cpu",
                                timeout=60, threads=1)
    blocks = [_block(r) for r in range(4)]
    for rank, got in enumerate(res):
        d, m = divmod(rank, 2)
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["rank_at"] == 2 * d + 1 and got["constrained"]
        torch.testing.assert_close(got["sum"],
                                   blocks[2 * d] + blocks[2 * d + 1])
        torch.testing.assert_close(got["max"],
                                   torch.maximum(blocks[m], blocks[2 + m]))
        torch.testing.assert_close(got["gather"], torch.cat(blocks, 1))
        torch.testing.assert_close(got["bcast"], blocks[2 * d + 1])
    one = port_mesh.make_host_mesh(device="cpu")
    assert one.shape == {"data": 1, "model": 1} and one.backend is None
    x = _block(0)
    for out in (collectives.all_reduce_sum(x, ("model",), one),
                collectives.all_reduce_max(x, ("data",), one),
                collectives.all_gather(x, 0, ("data", "model"), one),
                collectives.broadcast(x, ("model",), 0, one)):
        assert out is x
    y = x[None]
    assert paxes.constrain(y, "batch") is y
