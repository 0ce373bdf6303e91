"""The port's examples, the counterparts of the scripts under
``examples/``: each runs with ``python -m repro_torch.examples.<name>``,
on the card by default and on the CPU with ``--device cpu``, at reduced
configs.

  quickstart     build an architecture, take train steps, serve a batch
  serve_decode   continuous batching with more requests than slots
  autotune_demo  the paper's method on one kernel: calibrate the
                 counters, pick a block multiplier, check the kernel
  qsim_demo      a random circuit through the Qsim versions
"""
