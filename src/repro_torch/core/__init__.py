"""The paper's portable-performance layer, ported to the H100.

  costmodel — ``HWSpec``: the H100 variants' memory rate, L2 size and
              dense peaks, from NVIDIA's data sheets
  microbench — ceilings and measured rates per op class (paper C1):
              elementwise arithmetic, unit-stride and strided memory
  veceval   — the scalar / compiler (``torch.compile``) / hand-kernel
              comparison over the six proxy apps (paper §5, Fig 5)
  ophist    — the executed-op histogram and its Fig 6 classes (the
              counterpart of the reference's ``hlo``)
  counters  — Table 1: torch's counters calibrated on known-count
              programs (paper C2)
  autotune  — the block-multiplier ("LMUL") cost model over the SM's
              on-chip budget, measured sweeps, the best-config cache and
              the paged kernel's split tuning (paper C4, Fig 7)
"""
