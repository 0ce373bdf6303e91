"""The device mesh on ``torch.distributed``: one process a mesh position.

Counterpart of ``repro.launch.mesh``.  The reference builds a
``jax.sharding.Mesh`` over the devices of one controller and lets XLA lay
arrays out and insert collectives; the port runs one process (a rank) a
mesh position and makes the collectives itself
(``parallel.collectives``).  A ``Mesh`` has the reference's axis names
(``data``; ``data, model``; ``pod, data, model``) and ``shape`` dict, this
rank's coordinates (row-major over the axes, as the reference's device
array), its device, and one process group a line of each set of axes
through it: every rank creates every group in the same order, since
``dist.new_group`` deadlocks otherwise, each with a 60 s timeout, so a
rank that diverges fails instead of hanging.

``parse_mesh`` has the reference's grammar and refusals: ``None``,
``""``, ``"none"`` and ``"1"`` select no mesh (the unsharded engine, a
strict no-op); ``"N"``, ``"NxM"``, ``"NxMxK"`` name ``data``, ``data x
model`` and ``pod x data x model``; anything else raises ``ValueError``,
and a mesh whose size is not the world's raises ``RuntimeError``.  A mesh
of one position needs no process group.

The backend (``backend_for``): ``nccl`` where every rank of the host has
a card of its own; ``gloo`` where ranks share a card (NCCL refuses two
ranks on one device) and on the CPU.  ``spawn_ranks`` starts a world of
ranks on this host (``torch.multiprocessing``, spawn), rendezvoused
through a ``FileStore`` (no TCP port), and returns each rank's result
or raises on a rank's failure or on its own timeout.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import queue as queue_mod
import tempfile
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

AXIS_NAMES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


class Mesh:
    """A logical mesh of ranks: ``axis_names``, ``shape`` (name -> size,
    in axis order), ``rank`` and ``coords`` (name -> coordinate),
    ``device`` (this rank's), ``backend`` (the process group's, or
    ``None`` for a one-position mesh).  ``timing``: ``None``, or a list
    the collectives append their CUDA events to."""

    def __init__(self, dims: Sequence[int], names: Sequence[str], *,
                 rank: int = 0, device=None, backend: Optional[str] = None):
        if len(dims) != len(names):
            raise ValueError(f"{len(dims)} dims for axes {tuple(names)}")
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = {n: int(d) for n, d in zip(names, dims)}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = self.coords_of(rank)
        self.device = torch.device(device if device is not None
                                   else rank_device(rank))
        self.backend = backend
        self.timing: Optional[list] = None
        self._groups: Dict[Tuple[str, ...], Any] = {}

    def coords_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {n: out[n] for n in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in axes)

    def line(self, axes: Sequence[str], rank: Optional[int] = None
             ) -> List[int]:
        """The ranks that differ from ``rank`` (this one) only along
        ``axes``, in block order (row-major over ``axes`` as given)."""
        base = self.coords_of(self.rank if rank is None else rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(base)
            c.update(zip(axes, idx))
            out.append(self.rank_of(c))
        return out

    def rank_at(self, axes: Sequence[str], index: int) -> int:
        """The global rank at block ``index`` of this rank's line along
        ``axes``."""
        return self.line(axes)[index]

    def group(self, axes: Sequence[str]):
        key = self._key(axes)
        if key not in self._groups:
            raise RuntimeError(
                f"no process group for axes {key} on {self!r}: build the "
                f"mesh with make_mesh inside a world of {self.size} ranks")
        return self._groups[key]

    def make_groups(self) -> None:
        """One group a line of every set of axes spanning more than one
        rank; every rank creates them all, in the same order."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                rest = [a for a in names if a not in axes]
                for idx in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    c = dict(zip(rest, idx), **{a: 0 for a in axes})
                    ranks = sorted(self.line(axes, self.rank_of(c)))
                    g = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def __repr__(self):
        dims = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return (f"Mesh({dims}; rank {self.rank} at {self.coords}; "
                f"{self.backend or 'no process group'}; {self.device})")


def rank_device(rank: Optional[int] = None) -> torch.device:
    """``cuda:{local_rank % device_count}``: this rank's card."""
    local = int(os.environ.get("LOCAL_RANK", rank if rank is not None
                               else 0))
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for this rank: pass "
                           "device='cpu' to serve on the CPU")
    return torch.device(f"cuda:{local % n}")


def backend_for(device_type: str, local_world_size: int) -> str:
    """``nccl`` where each of the host's ranks has a card of its own,
    ``gloo`` where ranks share a card and on the CPU."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, *, device_type: str,
                       store=None, init_method: Optional[str] = None) -> str:
    """Initialise the default group with ``backend_for``'s backend and
    the 60 s timeout; returns the backend."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = backend_for(device_type, local)
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=GROUP_TIMEOUT)
    return backend


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device=None) -> Mesh:
    """The mesh over this world's ranks (one position a rank, row-major),
    with its process groups.  A mesh of one position needs no process
    group; any other raises unless the world has exactly its size."""
    n = math.prod(axis_shapes)
    if n == 1 and not dist.is_initialized():
        return Mesh(axis_shapes, axis_names, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"mesh {tuple(axis_shapes)} needs a world of {n} ranks; this "
            f"one has {world} (launch.serve --mesh spawns them, or run "
            f"under torchrun --nproc-per-node {n})")
    mesh = Mesh(axis_shapes, axis_names, rank=dist.get_rank(),
                device=device, backend=dist.get_backend())
    mesh.make_groups()
    return mesh


def parse_mesh_dims(spec: Optional[str]
                    ) -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """The reference's grammar: ``(dims, axis names)``, or ``None`` for
    no mesh; ``ValueError`` for a bad spec."""
    if spec is None or spec.lower() in ("", "none", "1"):
        return None
    try:
        dims = tuple(int(d) for d in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: want N, NxM, or NxMxK")
    names = AXIS_NAMES.get(len(dims))
    if names is None or any(d < 1 for d in dims):
        raise ValueError(f"bad mesh spec {spec!r}: want N, NxM, or NxMxK")
    return dims, names


def parse_mesh(spec: Optional[str], *, device=None) -> Optional[Mesh]:
    """CLI mesh spec -> Mesh (or None for the unsharded no-op path):
    ``"2"`` -> (data=2); ``"2x4"`` -> (data=2, model=4); ``"2x4x4"`` ->
    (pod=2, data=4, model=4).  Raises unless the world size equals the
    product of the dims."""
    parsed = parse_mesh_dims(spec)
    if parsed is None:
        return None
    return make_mesh(*parsed, device=device)


def make_host_mesh(model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over this world's ranks (tests, examples)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n // model, model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# a world of ranks on this host
# ---------------------------------------------------------------------------
def _rank_main(rank: int, world_size: int, store_path: str,
               device_type: str, threads: int, fn: Callable, args: tuple,
               results) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        init_process_group(rank, world_size, device_type=device_type,
                           store=dist.FileStore(store_path, world_size))
        if device_type == "cuda":
            torch.cuda.set_device(rank_device(rank))
        out = fn(rank, *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), *,
                device_type: str = "cuda", timeout: float = 300.0,
                store_dir: Optional[str] = None,
                threads: int = 0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, each
    with the default process group initialised (``init_process_group``)
    and, on the card, its device set; return the results by rank.

    ``fn`` and ``args`` are pickled (``fn`` a module-level function).
    The ranks rendezvous through a ``FileStore`` in ``store_dir`` (a new
    temporary directory by default).  Raises ``RuntimeError`` with the
    rank's traceback as soon as one fails, and ``TimeoutError`` if the
    results are not all in within ``timeout`` seconds; either way every
    rank still alive is killed.  ``threads`` sets each rank's torch
    threads (0: torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, store, device_type,
                                   threads, fn, args, results))
                 for r in range(world_size)]
        expired = threading.Event()
        timer = threading.Timer(timeout, expired.set)
        timer.daemon = True
        for p in procs:
            p.start()
        timer.start()
        out: Dict[int, Any] = {}
        try:
            while len(out) < world_size:
                if expired.is_set():
                    raise TimeoutError(
                        f"{world_size - len(out)} of {world_size} ranks "
                        f"gave no result within {timeout} s")
                try:
                    rank, status, value = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=30)
        finally:
            timer.cancel()
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]
