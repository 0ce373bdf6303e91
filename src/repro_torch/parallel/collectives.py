"""The collectives the port makes itself where XLA inserts them into the
reference's sharded program: sums and maxima over a mesh axis's line of
ranks, a gather along a tensor dim, a broadcast.

Each takes the mesh axes it runs over (a logical axis's ``rule_axes``)
and is a no-op where they span one rank.  One code path serves every
backend: the ``gloo`` backend takes only ``broadcast`` and
``all_reduce`` on CUDA tensors, so ``all_gather`` is an ``all_reduce``
SUM of a zero-filled buffer in which each rank has written its own block
(adding zeros is exact).  Under ``gloo`` a bfloat16 tensor is reduced in
float32 and rounded back once.  Where the mesh has a ``timing`` list (a
card only), each collective appends its (start, end) CUDA events to it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel import axes as paxes


def _setup(axes: Sequence[str], mesh):
    mesh = mesh if mesh is not None else paxes.current_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs a mesh (or an active "
                           "sharding_ctx)")
    return mesh, paxes.axes_size(mesh, axes)


def _reduce(t: torch.Tensor, op, axes, mesh) -> torch.Tensor:
    group = mesh.group(axes)
    events = _start(mesh, t)
    work = t.contiguous()
    low = mesh.backend == "gloo" and work.dtype == torch.bfloat16
    if low:
        work = work.float()
    dist.all_reduce(work, op=op, group=group)
    if low:
        work = work.to(torch.bfloat16)
    _end(mesh, events)
    return work


def _start(mesh, t):
    if getattr(mesh, "timing", None) is None or t.device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


def _end(mesh, events):
    if events is not None:
        events[1].record()
        mesh.timing.append(events)


def all_reduce_sum(t: torch.Tensor, axes: Sequence[str],
                   mesh=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes`` (through this rank);
    reduces in place where ``t`` is contiguous (and not bfloat16 under
    gloo) and returns the result."""
    mesh, n = _setup(axes, mesh)
    if n == 1:
        return t
    return _reduce(t, dist.ReduceOp.SUM, axes, mesh)


def all_reduce_max(t: torch.Tensor, axes: Sequence[str],
                   mesh=None) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of ``axes``."""
    mesh, n = _setup(axes, mesh)
    if n == 1:
        return t
    return _reduce(t, dist.ReduceOp.MAX, axes, mesh)


def all_gather(t: torch.Tensor, dim: int, axes: Sequence[str],
               mesh=None) -> torch.Tensor:
    """The blocks of ``axes``' ranks concatenated along ``dim``, in the
    order ``local_slice`` cuts them: a zero buffer holding this rank's
    block at its index, summed over the ranks."""
    mesh, n = _setup(axes, mesh)
    if n == 1:
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    size = shape[dim]
    shape[dim] = size * n
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, paxes.axes_index(mesh, axes) * size, size).copy_(t)
    return _reduce(buf, dist.ReduceOp.SUM, axes, mesh)


def broadcast(t: torch.Tensor, axes: Sequence[str], src: int = 0,
              mesh=None) -> torch.Tensor:
    """``t`` of the rank at block index ``src`` along ``axes``, on every
    rank of them (in place; ``t`` must be contiguous)."""
    mesh, n = _setup(axes, mesh)
    if n == 1:
        return t
    if not t.is_contiguous():
        raise ValueError("broadcast needs a contiguous tensor")
    events = _start(mesh, t)
    dist.broadcast(t, src=mesh.rank_at(axes, src), group=mesh.group(axes))
    _end(mesh, events)
    return t
