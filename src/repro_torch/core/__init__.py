"""The paper's portable-performance layer, ported to the H100.

  costmodel — ``HWSpec``: the H100 variants' memory rate, L2 size and
              dense peaks, from NVIDIA's data sheets
  microbench — ceilings and measured rates per op class (paper C1):
              elementwise arithmetic, unit-stride and strided memory
  veceval   — the scalar / compiler (``torch.compile``) / hand-kernel
              comparison over the six proxy apps (paper §5, Fig 5)
"""
