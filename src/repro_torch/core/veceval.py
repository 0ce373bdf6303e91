"""The scalar / compiler / hand-kernel comparison over the six proxy apps
(paper §5, Fig 5): the counterpart of ``repro.core.veceval``.

Version mapping, on the H100:
  scalar   — an eager row loop, one row per iteration (the JAX
             ``fori_loop``): the "-fno-tree-vectorize" analogue.  Each
             iteration is a few kernel launches, so its time is the
             host's launch rate, not the card's.
  autovec  — the idiomatic torch expression.  On a CUDA device it runs
             through ``torch.compile(fullgraph=True, dynamic=False)``:
             Inductor's version, the compiler's column.  On the CPU it
             runs eager.
  kernel   — the port's ``ops``, which on a CUDA device launch the
             hand-written kernels (STREAM triad, ELL SpMV, GEMM, direct
             conv2d): the "RVV intrinsics" column.

The builders take the JAX builders' size arguments (plus GEMM and conv
sizes, which the JAX package fixes) and make the same inputs from the
same numpy seeds, bit for bit.  Rows keep the JAX keys, except that
``tpu_model_seconds`` becomes ``bound_seconds`` (the larger of the
app's bytes over the memory rate and its operations over the peak for
its type, from ``HWSpec``) with ``hw`` naming the spec.  ``host_seconds``
keeps its JAX name but holds the median time between two CUDA events on
the card (``repro_torch.perf.measure``); there is no host clock here.
``flops`` and ``bytes`` are the app's analytic values (``source
"model"``): the operations and the bytes of every input read once and
every output written once.  ``hlo_ops``, ``instruction_classes`` and
``op_reduction_vs_scalar`` stay ``None`` until the counter layer is
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.costmodel import HWSpec, hw_of
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import pads
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv.ref import random_ell
from repro_torch.kernels.stream import ops as stream_ops
from repro_torch.perf.measure import measure_group

VERSIONS = ("scalar", "autovec", "kernel")
REPS = 5                           # timed rounds per app


@dataclasses.dataclass
class AppVersion:
    name: str                      # scalar | autovec | kernel
    fn: Callable
    args: tuple
    iters: int = 1                 # host loop iterations (scalar's rows)


@dataclasses.dataclass
class ProxyApp:
    name: str
    versions: List[AppVersion]
    flops: float                   # useful flops of the task
    bytes_moved: float             # inputs read once + outputs written once
    dtype: torch.dtype             # the type the arithmetic runs in
    rtol: float                    # versions agree within rtol * scale + atol
    atol: float
    scale: Optional[torch.Tensor] = None   # per output; None: |reference|

    @property
    def device(self) -> torch.device:
        return self.versions[0].args[0].device

    def max_err(self, got: torch.Tensor, want: torch.Tensor) -> float:
        """Max |got - want|; raises if any element is past the app's
        tolerance or the shapes differ."""
        if got.shape != want.shape:
            raise AssertionError(f"{self.name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        # in place where it can: at card sizes an output is 256 MiB
        err = (got - want).abs_()
        lim = want.abs() if self.scale is None else self.scale.clone()
        bad = ~(err <= lim.mul_(self.rtol).add_(self.atol))
        if bool(bad.any()):
            raise AssertionError(
                f"{self.name}: {int(bad.sum())} of {err.numel()} elements "
                f"past rtol {self.rtol} atol {self.atol} (max abs err "
                f"{float(err.max()):.3e})")
        return float(err.max()) if err.numel() else 0.0


def _rng(i):
    return np.random.default_rng(i)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _compiled(fn: Callable, device: torch.device) -> Callable:
    """Inductor's version on a CUDA device; the expression as it is on the
    CPU (where only the tests run it)."""
    if device.type == "cuda":
        return torch.compile(fn, fullgraph=True, dynamic=False)
    return fn


# ---------------------------------------------------------------------------
# the six proxy apps
# ---------------------------------------------------------------------------
def build_stream(n: int = 1 << 21, *, device=None) -> ProxyApp:
    dev = resolve_device(device)
    x = _tensor(_rng(0).random(n).astype(np.float32), dev)
    y = _tensor(_rng(1).random(n).astype(np.float32), dev)

    def autovec(x, y):
        return x + 2.0 * y

    def scalar(x, y):
        rows = x.view(-1, 128)
        yr = y.view(-1, 128)
        out = torch.zeros_like(rows)
        for i in range(rows.shape[0]):
            out[i] = rows[i] + 2.0 * yr[i]
        return out.view(-1)

    def kernel(x, y):
        return stream_ops.stream("triad", x.view(-1, 128),
                                 y.view(-1, 128)).view(-1)

    return ProxyApp("stream", [
        AppVersion("scalar", scalar, (x, y), iters=n // 128),
        AppVersion("autovec", _compiled(autovec, dev), (x, y)),
        AppVersion("kernel", kernel, (x, y)),
    ], flops=n * 2.0, bytes_moved=n * 12.0, dtype=torch.float32,
        rtol=1e-6, atol=0.0)


def build_spmv(rows: int = 1 << 14, cols: int = 1 << 14, nnz: int = 16, *,
               device=None) -> ProxyApp:
    dev = resolve_device(device)
    vals_np, cols_np = random_ell(4, rows, cols, nnz)
    vals, colsj = _tensor(vals_np, dev), _tensor(cols_np, dev)
    x = _tensor(_rng(5).random(cols).astype(np.float32), dev)

    def autovec(vals, colsj, x):
        return torch.sum(vals * x[colsj], dim=-1)

    def scalar(vals, colsj, x):
        out = torch.zeros((vals.shape[0],), dtype=torch.float32,
                          device=vals.device)
        for i in range(vals.shape[0]):
            out[i] = torch.sum(vals[i] * x[colsj[i]])
        return out

    def kernel(vals, colsj, x):
        return spmv_ops.spmv_ell(vals, colsj, x, idiom="take")[:, 0]

    # a sum of nnz products of both signs: hold each row to the scale of
    # its terms (sum |v * x|), not of its possibly cancelled total
    scale = torch.sum((vals * x[colsj]).abs_(), dim=-1)
    return ProxyApp("spmv", [
        AppVersion("scalar", scalar, (vals, colsj, x), iters=rows),
        AppVersion("autovec", _compiled(autovec, dev), (vals, colsj, x)),
        AppVersion("kernel", kernel, (vals, colsj, x)),
    ], flops=rows * nnz * 2.0,
        bytes_moved=rows * nnz * 8.0 + cols * 4.0 + rows * 4.0,
        dtype=torch.float32, rtol=1e-6, atol=0.0, scale=scale)


def _gemm_app(name: str, dtype: torch.dtype, M=512, K=512, N=512, *,
              device=None) -> ProxyApp:
    dev = resolve_device(device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    a = _tensor(_rng(6).random((M, K)).astype(np_dtype), dev)
    b = _tensor(_rng(7).random((K, N)).astype(np_dtype), dev)

    def autovec(a, b):
        return a @ b

    def scalar(a, b):
        out = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                          device=a.device)
        for i in range(a.shape[0]):
            out[i] = a[i] @ b
        return out

    def kernel(a, b):
        return gemm_ops.gemm(a, b, block_multiplier=2, bk=256)

    tol = 1e-12 if dtype == torch.float64 else 1e-4
    return ProxyApp(name, [
        AppVersion("scalar", scalar, (a, b), iters=M),
        AppVersion("autovec", _compiled(autovec, dev), (a, b)),
        AppVersion("kernel", kernel, (a, b)),
    ], flops=2.0 * M * K * N,
        bytes_moved=(M * K + K * N + M * N) * float(a.element_size()),
        dtype=dtype,
        rtol=tol, atol=tol)


def build_sgemm(M: int = 512, K: int = 512, N: int = 512, *,
                device=None) -> ProxyApp:
    return _gemm_app("sgemm", torch.float32, M, K, N, device=device)


def build_dgemm(M: int = 512, K: int = 512, N: int = 512, *,
                device=None) -> ProxyApp:
    # f64 throughout: the H100 has fp64 units (the JAX package maps DGEMM
    # to f32 on the TPU unless x64 is on, and its kernel accumulates in f32)
    return _gemm_app("dgemm", torch.float64, M, K, N, device=device)


def _leaky(x):
    return torch.maximum(x, 0.1 * x)


def _conv_net(name: str, specs, H=32, W=32, Cin=16, *,
              device=None) -> ProxyApp:
    dev = resolve_device(device)
    x = _tensor(_rng(8).random((1, H, W, Cin)).astype(np.float32), dev)
    ws = []
    cin = Cin
    for (k, cout) in specs:
        ws.append(_tensor((_rng(9 + len(ws)).random((k, k, cin, cout))
                           * 0.1).astype(np.float32), dev))
        cin = cout

    def autovec(x, *ws):
        xn = x.permute(0, 3, 1, 2)                         # NCHW
        for w in ws:
            (pt, pb), (pl, pr) = pads(w.shape[0]), pads(w.shape[1])
            xn = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w.permute(3, 2, 0, 1))
            xn = _leaky(xn)
        return xn.permute(0, 2, 3, 1)

    def scalar(x, *ws):
        # row-at-a-time im2col: the scalar-issue analogue
        for w in ws:
            k = w.shape[0]
            pad = k // 2
            xp = F.pad(x, (0, 0, pad, k - 1 - pad, pad, k - 1 - pad))
            hh, ww_, co = x.shape[1], x.shape[2], w.shape[3]
            wm = w.reshape(-1, co)
            out = torch.zeros((1, hh, ww_, co), dtype=x.dtype,
                              device=x.device)
            for i in range(hh):
                rows = xp[:, i:i + k]                      # (1, k, W+k-1, ci)
                patches = torch.stack([rows[:, :, dx:dx + ww_]
                                       for dx in range(k)], dim=3)
                patch = patches.permute(0, 2, 1, 3, 4).reshape(ww_, -1)
                out[:, i] = (patch @ wm).reshape(1, ww_, co)
            x = _leaky(out)
        return x

    def kernel(x, *ws):
        for w in ws:
            x = _leaky(conv_ops.conv2d_same(x, w, block_h=8))
        return x

    fl = 0.0
    act = H * W * Cin                  # the input, read once
    cin = Cin
    for i, (k, cout) in enumerate(specs):
        fl += 2.0 * H * W * k * k * cin * cout
        # each layer's output written once, and read once by the next
        act += H * W * cout * (1 if i == len(specs) - 1 else 2)
        cin = cout
    nbytes = 4.0 * (act + sum(w.numel() for w in ws))
    return ProxyApp(name, [
        AppVersion("scalar", scalar, (x, *ws), iters=H * len(specs)),
        AppVersion("autovec", _compiled(autovec, dev), (x, *ws)),
        AppVersion("kernel", kernel, (x, *ws)),
    ], flops=fl, bytes_moved=nbytes, dtype=torch.float32, rtol=1e-4,
        atol=1e-4)


ALEXNET_SPECS = [(3, 32), (3, 64), (3, 64)]
YOLOV3_SPECS = [(1, 8), (3, 32), (1, 16), (3, 32)]


def build_alexnet(H: int = 32, W: int = 32, Cin: int = 16, *,
                  device=None) -> ProxyApp:
    # AlexNet-ish middle stack (3x3 convs)
    return _conv_net("alexnet", ALEXNET_SPECS, H, W, Cin, device=device)


def build_yolov3(H: int = 32, W: int = 32, Cin: int = 16, *,
                 device=None) -> ProxyApp:
    # YOLOv3-ish residual cell: 1x1 reduce + 3x3 expand, twice
    return _conv_net("yolov3", YOLOV3_SPECS, H, W, Cin, device=device)


BUILDERS: Dict[str, Callable[..., ProxyApp]] = {
    "stream": build_stream,
    "spmv": build_spmv,
    "sgemm": build_sgemm,
    "dgemm": build_dgemm,
    "alexnet": build_alexnet,
    "yolov3": build_yolov3,
}


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------
def evaluate_app(app: ProxyApp, measure: bool = True, *,
                 hw: Optional[HWSpec] = None,
                 scalar_max_iters: Optional[int] = None) -> List[Dict]:
    """One row per version.  With ``measure`` (needs the card) the versions
    are timed in the same interleaved rounds, the L2 flushed before each
    call, and every version's output is held against autovec's within the
    app's tolerance (raises if one is past it).  A version whose host loop
    runs more than ``scalar_max_iters`` iterations is not run; its row says
    why."""
    dev = app.device
    hw = hw_of(dev, hw)
    bound_s, bound_by = hw.bound_s(app.flops, app.bytes_moved, app.dtype)
    omitted = {v.name: (f"host loop of {v.iters} iterations > "
                        f"{scalar_max_iters}: it would time the host's "
                        f"launches, not the card")
               for v in app.versions
               if scalar_max_iters is not None and v.iters > scalar_max_iters}
    meas, errs = {}, {}
    if measure:
        meas = measure_group({v.name: (v.fn, v.args) for v in app.versions
                              if v.name not in omitted},
                             reps=REPS, flush_l2=True, cover_ms=2.0)
        want = meas["autovec"].result
        errs = {name: app.max_err(m.result, want)
                for name, m in meas.items()}
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rows = []
    for v in app.versions:
        m = meas.get(v.name)
        rows.append({
            "app": app.name, "version": v.name,
            "host_seconds": m.median_s if m else None,
            "first_call_seconds": m.first_s if m else None,
            "bound_seconds": bound_s, "bound_by": bound_by, "hw": hw.name,
            "device": device_name,
            "flops": app.flops, "flops_source": "model",
            "bytes": app.bytes_moved, "bytes_source": "model",
            "hlo_ops": None, "instruction_classes": None,
            "op_reduction_vs_scalar": None,
            "useful_flops": app.flops,
            "max_abs_err_vs_autovec": errs.get(v.name),
            "omitted": omitted.get(v.name),
        })
    return rows


def run_all(measure: bool = True, apps: Optional[List[str]] = None, *,
            device=None, sizes: Optional[Dict[str, Dict]] = None,
            scalar_max_iters: Optional[int] = None,
            hw: Optional[HWSpec] = None) -> List[Dict]:
    """Build and evaluate every app (or those named in ``apps``) on
    ``device`` (``cuda`` unless named).  ``sizes`` maps an app's name to
    keyword arguments of its builder."""
    rows = []
    for name, builder in BUILDERS.items():
        if apps and name not in apps:
            continue
        app = builder(**(sizes or {}).get(name, {}), device=device)
        rows.extend(evaluate_app(app, measure, hw=hw,
                                 scalar_max_iters=scalar_max_iters))
    return rows
