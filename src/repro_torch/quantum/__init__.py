"""The paper's Qsim study (§6), ported to the H100.

  gates — the gate set and seeded random circuits (a copy of the JAX
          package's, numpy only)
  qsim  — the state-vector simulator: nonvec, autovec and kernel versions
          over the interleaved and planar layouts
"""
