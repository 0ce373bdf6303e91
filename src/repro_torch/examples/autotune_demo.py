"""The paper's method end to end on one kernel: calibrate the counters,
pick a block multiplier from the cost model ("the compiler's LMUL
choice"), check it against a measured sweep on the card, and hold the
kernel at that multiplier against its plain version.  The counterpart of
``examples/autotune_demo.py``.

    python -m repro_torch.examples.autotune_demo
    python -m repro_torch.examples.autotune_demo --device cpu

The GEMM is B6 in fp32 (the reference's demo multiplies bf16 on the MXU;
the port's B6 takes fp32 on the CUDA cores and fp64 on the tensor
cores).  On the CPU the wrapper runs the plain version and nothing is
timed.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import autotune, counters
from repro_torch.kernels.common import VALID_MULTIPLIERS, resolve_device
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm import ref as gemm_ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--size", type=int, default=2048,
                    help="the modeled (and, on the card, measured) GEMM")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"1) counter calibration (Table 1's method) on {dev}")
    summary = counters.summarize(counters.calibrate(n=1 << 14, steps=4,
                                                    device=dev))
    for ch, ok in summary.items():
        print(f"   {ch:24s} {'reliable' if ok else 'UNRELIABLE'}")

    n = args.size
    print(f"\n2) block-multiplier selection for gemm {n}^3 (fp32)")
    ks = autotune.gemm_shape(n, n, n, torch.float32)
    best, reports = autotune.select_multiplier(ks)
    for r in reports:
        mark = " <- selected" if r.multiplier == best else ""
        print(f"   m={r.multiplier}: smem {r.working_set / 1024:6.1f} KiB "
              f"{r.blocks_per_sm} a SM {r.waves:3d} waves "
              f"t={r.predicted_s * 1e3:8.3f}ms bound={r.bound:8s}{mark}")

    g = np.random.default_rng(0)
    measured = None
    if dev.type == "cuda":
        a = torch.from_numpy(g.random((n, n), dtype=np.float32)).to(dev)
        b = torch.from_numpy(g.random((n, n), dtype=np.float32)).to(dev)
        measured = autotune.measured_sweep(
            {f"m{m}": (lambda a, b, m=m: gemm_ops.gemm(
                a, b, block_multiplier=m), (a, b))
             for m in VALID_MULTIPLIERS})
        fastest = min(measured, key=measured.get)
        print("   measured (CUDA events, medians): " + ", ".join(
            f"{k} {t * 1e3:.3f} ms" for k, t in measured.items())
            + f"; fastest {fastest}, the model's pick m{best} at "
              f"{measured[f'm{best}'] / measured[fastest]:.2f}x it")

    print(f"\n3) the kernel at m={best} against the plain version")
    a = torch.from_numpy(g.standard_normal((512, 512), dtype=np.float32))
    b = torch.from_numpy(g.standard_normal((512, 512), dtype=np.float32))
    got = gemm_ops.gemm(a.to(dev), b.to(dev), block_multiplier=best).cpu()
    want = gemm_ref.gemm(a, b)
    err = float((got - want).abs().max())
    what = "the CUDA kernel" if dev.type == "cuda" else "the plain version"
    print(f"   max|err| = {err:.3e}  ({what} against the plain product)")
    if err >= 1e-3:
        raise AssertionError(f"gemm at m={best}: max abs err {err:.3e}")
    print("   OK")
    return {"verdicts": summary, "best": best, "measured": measured,
            "max_abs_err": err}


if __name__ == "__main__":
    main()
