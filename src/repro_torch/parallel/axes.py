"""Logical-axis sharding: model code names axes logically ("batch", "mlp",
"heads", ...); a context-installed rule set maps them to physical mesh
axes.

Counterpart of ``repro.parallel.axes``: ``DEFAULT_RULES``,
``sharding_ctx``, ``active``, ``current_mesh``, ``rule_axes``,
``decisions`` and the resolver are the reference's.  The resolver
enforces divisibility: a logical axis whose rule maps to a mesh axis
that does not divide the tensor dim is dropped (replicated) and the
decision is recorded, e.g. phi3-medium's 10 KV heads on a 16-way model
axis.

Where the reference hands a ``NamedSharding`` to XLA, the port lays the
tensors out itself: one process a mesh position (``launch.mesh.Mesh``),
each holding ``local_slice`` of every leaf, the block of each sharded
dim at this rank's coordinate, contiguous in the mesh's row-major order
as a ``NamedSharding`` lays it out.  The resolver reads only
``mesh.shape``, so any object with a ``shape`` dict resolves specs; only
``local_slice``, ``rule_index`` and the collectives need a rank.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

AxisName = Union[str, None]
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default physical rules for the production meshes in launch/mesh.py.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,            # decode hillclimb: map to "model" for SP-KV
    "embed": None,
    "heads": "model",
    "kv_heads": "model",       # dropped automatically when not divisible
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,        # grok fallback: experts too few -> TP on d_ff
    "state": None,
    "conv": None,
    "layers": None,
    "image_tokens": None,
    "audio_ctx": None,
}


class PartitionSpec(tuple):
    """A resolved spec: per tensor dim, a mesh axis name, a tuple of them
    (the dim split over their product, the first the major one), or
    ``None`` (whole), trailing ``None``\\ s dropped, as
    ``jax.sharding.PartitionSpec`` holds it."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Rules] = None
        self.decisions: List[str] = []


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Rules] = None):
    """Install (mesh, rules) for the duration of a forward (the
    reference's: of a trace/lower call)."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.decisions)
    _CTX.mesh, _CTX.rules, _CTX.decisions = (mesh, dict(rules or
                                                        DEFAULT_RULES), [])
    try:
        yield _CTX
    finally:
        _CTX.mesh, _CTX.rules, _CTX.decisions = prev


def active() -> bool:
    return _CTX.mesh is not None


def current_mesh():
    return _CTX.mesh


def rule_axes(name: str) -> Tuple[str, ...]:
    """Mesh axes a logical axis maps to under the active rules (or ())."""
    if not active():
        return ()
    phys = (_CTX.rules or {}).get(name)
    if phys is None:
        return ()
    axes = phys if isinstance(phys, tuple) else (phys,)
    return tuple(a for a in axes if a in _CTX.mesh.shape)


def decisions() -> List[str]:
    return list(_CTX.decisions)


def _mesh_axis_size(mesh, axis: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def resolve_spec(
    logical: Sequence[AxisName],
    shape: Sequence[int],
    mesh=None,
    rules: Optional[Rules] = None,
    record: bool = True,
) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, dropping non-divisible
    axes."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    if mesh is None:
        raise ValueError("resolve_spec needs an active sharding_ctx or mesh")
    out, used = [], set()
    for dim, name in zip(shape, logical):
        phys = rules.get(name) if name else None
        if phys is None:
            out.append(None)
            continue
        axes = phys if isinstance(phys, tuple) else (phys,)
        axes = tuple(a for a in axes if a in mesh.shape)
        if not axes:
            out.append(None)
            continue
        if any(a in used for a in axes):
            out.append(None)  # a mesh axis may appear only once per spec
            continue
        size = _mesh_axis_size(mesh, axes)
        if dim % size != 0:
            if record and _CTX.decisions is not None:
                _CTX.decisions.append(
                    f"replicated logical axis {name!r} (dim {dim}) — not divisible "
                    f"by mesh axes {axes} (size {size})"
                )
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one resolved spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's block index along ``axes``: its coordinates over them,
    row-major (the first axis the major one)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def rule_size(name: str) -> int:
    """How many blocks the active rules split a logical axis into (1
    outside a context or where it maps to no mesh axis)."""
    return axes_size(_CTX.mesh, rule_axes(name)) if active() else 1


def rule_index(name: str) -> int:
    """This rank's block of a logical axis under the active rules."""
    return axes_index(_CTX.mesh, rule_axes(name)) if active() else 0


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= axes_size(mesh, entry_axes(entry))
    return tuple(out)


def local_slice(t, spec: PartitionSpec, mesh):
    """The block of ``t`` (a tensor or a numpy array, a memory map too)
    this rank holds under ``spec``: a basic-slicing view, so a memory
    map reads only that block when it is copied."""
    index = []
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            index.append(slice(None))
            continue
        n = t.shape[d] // axes_size(mesh, axes)
        i = axes_index(mesh, axes)
        index.append(slice(i * n, (i + 1) * n))
    return t[tuple(index)] if index else t


def constrain(x, *logical: AxisName):
    """The reference's ``with_sharding_constraint`` by logical names.  The
    port's layout is explicit (every rank computes on its own blocks), so
    this only checks the rank: a no-op without a context."""
    if active() and len(logical) != x.dim():
        raise ValueError(f"constrain: {len(logical)} axes for "
                         f"rank-{x.dim()} tensor")
    return x


def _is_spec(s) -> bool:
    return isinstance(s, tuple)


def tree_shardings(spec_tree, shape_tree, mesh, rules: Optional[Rules] = None):
    """A resolved ``PartitionSpec`` a leaf, from (logical-spec tree, tree
    of tensors or of anything with a ``shape``): the reference's
    ``NamedSharding`` tree, keyed as the port's trees are.  Dicts are
    walked in sorted key order, as ``jax.tree.map`` walks them; a list is
    the port's layer stack, the reference's one stacked leaf, so only its
    first entry records forced-replication decisions."""
    rules = dict(rules or DEFAULT_RULES)

    def walk(spec, leaf, record):
        if isinstance(spec, dict):
            return {k: walk(spec[k], leaf[k], record) for k in sorted(spec)}
        if isinstance(spec, list):
            return [walk(s, t, record and i == 0)
                    for i, (s, t) in enumerate(zip(spec, leaf))]
        if not _is_spec(spec):
            raise TypeError(f"spec leaf {spec!r} is not a tuple")
        return resolve_spec(spec, leaf.shape, mesh, rules, record=record)

    return walk(spec_tree, shape_tree, True)


def shard_tree(tree, spec_tree, mesh, rules: Optional[Rules] = None):
    """Each leaf of ``tree`` cut to this rank's block under its resolved
    spec: a contiguous copy where the spec splits it (so the whole leaf
    can be freed), the leaf itself where it does not."""
    specs = tree_shardings(spec_tree, tree, mesh, rules)

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(t[k], spec[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, spec)]
        if all(e is None for e in spec):
            return t
        return local_slice(t, spec, mesh).clone(
            memory_format=torch.contiguous_format)

    return walk(tree, specs)
