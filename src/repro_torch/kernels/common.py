"""Device checks and the nvcc build helper shared by the kernel families.

Kernels are CUDA C++ with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` into a shared library and loaded with ``ctypes``.  The build
runs at first use, on the machine with the card, into ``build/kernels/``
at the repository root (git-ignored); the library's file name carries a
hash of its sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
REQUIRED_CAPABILITY: Tuple[int, int] = (9, 0)

# the JAX kernels' "LMUL" axis: tiles grouped {1, 2, 4, 8} at a time
VALID_MULTIPLIERS = (1, 2, 4, 8)


def check_multiplier(m: int) -> int:
    if m not in VALID_MULTIPLIERS:
        raise ValueError(f"block multiplier must be one of {VALID_MULTIPLIERS}")
    return m


def resolve_device(device=None) -> torch.device:
    """An entry point's device: ``cuda`` unless the caller names one."""
    return torch.device("cuda" if device is None else device)


def require_hopper(device: torch.device) -> int:
    """Raise unless ``device`` is a CUDA device of capability (9, 0);
    return its index.  The capability is read once a device a process: a
    wrapper on the decode path is called thousands of times a second."""
    if device.type != "cuda":
        raise RuntimeError(
            f"the CUDA kernel needs tensors on a CUDA device, got {device}")
    index = device.index
    if index is None:                     # "cuda": the current device
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA tensor given but no CUDA device is present")
        index = torch.cuda.current_device()
    return _hopper(index)


@functools.lru_cache(maxsize=None)
def _hopper(index: int) -> int:
    cap = torch.cuda.get_device_capability(index)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"kernel built for sm_90a needs capability "
            f"{REQUIRED_CAPABILITY}, {torch.cuda.get_device_name(index)} "
            f"has {cap}")
    return index


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once a process (the plans
    size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


class CallTable(dict):
    """A binding's checked and planned calls, by call signature: the
    checks and the plan run once a signature, so a call on the decode path
    costs little host time.  Past ``MAX_CALLS`` signatures the table
    starts again."""
    MAX_CALLS = 4096

    def lookup(self, key, make, *args):
        """The entry for ``key``, made by ``make(*args)`` the first time."""
        call = self.get(key)
        if call is None:
            if len(self) >= self.MAX_CALLS:
                self.clear()
            call = self[key] = make(*args)
        return call


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): on PATH or under
    CUDA_HOME."""
    path = shutil.which(name)
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        return os.path.join(CUDA_HOME, "bin", name)
    raise RuntimeError(f"{name} not found (on PATH or under CUDA_HOME)")


def library_path(name: str, sources: Sequence[pathlib.Path]) -> pathlib.Path:
    """Where ``build_library`` puts the library for these sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(pathlib.Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """Compile ``sources`` with nvcc (once per content hash) and load the
    shared library.  Raises with nvcc's output if the build fails."""
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)            # atomic: a reader never sees half
    return ctypes.CDLL(str(out))


def bind(lib: ctypes.CDLL, fn_name: str, *argtypes):
    """Declare ``int fn(*argtypes, void* stream)`` on ``lib`` and return
    the function.  Every launcher of this package takes the CUDA stream
    last and returns ``cudaGetLastError()``; every library exports
    ``const char* kernel_error_string(int)``."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def check_launch(lib: ctypes.CDLL, what: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream on ``t``'s device, as ctypes takes it
    (read without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (for kernels
    that copy 16-byte vectors): a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_operand(name: str, t: torch.Tensor, dtype, device,
                  shape=None, align: int = 0) -> None:
    """Raise unless ``t`` has this dtype, device, shape (if given), is
    contiguous and, if ``align``, starts at a multiple of ``align`` bytes."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")

