"""Hand-written Hopper kernels, one family per subpackage.

Each family keeps three parts: ``ref.py`` (the plain PyTorch version,
used for CPU tensors and as the on-card oracle), ``csrc/*.cu`` plus
``kernel.py`` (the CUDA C++ kernel and its ctypes binding), and
``ops.py`` (the public entry: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises).
"""
