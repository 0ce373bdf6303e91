"""Direct NHWC stride-1 SAME conv2d (veceval's AlexNet and YOLOv3 stacks).

- ``ref.py`` — the plain PyTorch version: the kh*kw shifted products the
  TPU kernel computes, over the same asymmetric padding.
- ``csrc/conv2d.cu`` + ``kernel.py`` — the CUDA kernel and its binding.
- ``ops.py`` — ``conv2d_same``: a CPU tensor runs the plain version, a
  CUDA tensor launches the kernel or raises.
"""
