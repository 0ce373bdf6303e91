"""The op histogram ("retired-instruction mix"): the counterpart of the
op-histogram half of ``repro.core.hlo``.

The reference parses the compiled HLO text and counts each instruction
once, so an op inside a ``while`` body (``lax.scan``, ``fori_loop``)
counts once whatever its trip count.  Here ``op_histogram(fn, *args)``
runs ``fn`` under a ``TorchDispatchMode`` and counts every aten op it
*executes*, by ``func.overloadpacket``: a loop of n iterations counts its
body n times.  The paper's counters count retired instructions, so the
executed count is the closer of the two to the paper.

What the dispatcher cannot see: the hand kernels, launched through
``ctypes`` (only their wrappers' torch ops, ``empty`` and views, reach
it), and code compiled by ``torch.compile`` (Dynamo refuses to run under
a dispatch mode: "non-infra torch dispatch mode present").  Their ops
are not counted.  On the card ``KernelRecorder`` reads the kernels the
card ran from ``torch.profiler``'s CUDA activity, which sees those too;
Table 1 calibrates that channel (``kernel_launches``), and its records
were not whole over a long process (see ``KernelRecorder``), so no op
count is taken from it.

``instruction_classes`` keeps the reference's six buckets (matmul,
elementwise, memory_movement, collective, control, other), with the
reference's placement of reductions and sorts under ``control``.  The
collective accounting of ``hlo.py`` (``CollectiveOp``, ring bytes) waits
for the device mesh (ROADMAP A10).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CLASSES = ("matmul", "elementwise", "memory_movement", "collective",
           "control", "other")

MATMUL_OPS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "matmul", "linear", "einsum", "convolution", "_convolution",
    "convolution_overrideable", "cudnn_convolution", "_slow_conv2d_forward",
    "conv1d", "conv2d", "conv3d", "_scaled_mm",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_flash_attention_forward",
    "_efficient_attention_forward"})
ELEMENTWISE_OPS = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "exp", "exp_", "exp2", "expm1", "tanh", "maximum", "minimum", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "rsqrt", "sqrt", "neg", "log",
    "log_", "log1p", "log2", "pow", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "abs", "clamp", "clamp_", "clamp_min", "clamp_min_",
    "clamp_max", "floor", "ceil", "round", "trunc", "sign", "cos", "sin",
    "sigmoid", "silu", "gelu", "relu", "relu_", "leaky_relu", "addcmul",
    "addcdiv", "lerp", "reciprocal", "erf", "masked_fill", "masked_fill_",
    "remainder", "fmod", "isnan", "isinf", "nan_to_num", "square",
    "softplus", "hardtanh", "threshold"})
MEMORY_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "t", "expand", "select", "slice", "index", "index_select",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "index_put", "index_put_", "index_add", "index_add_", "index_copy",
    "index_copy_", "cat", "stack", "pad", "constant_pad_nd", "flip", "roll",
    "arange", "full", "full_like", "zeros", "zeros_like", "ones",
    "ones_like", "empty", "empty_like", "empty_strided", "new_zeros",
    "new_empty", "new_ones", "new_full", "clone", "copy_", "_to_copy",
    "contiguous", "unsqueeze", "unsqueeze_", "squeeze", "squeeze_",
    "as_strided", "lift_fresh", "lift_fresh_copy", "alias", "detach",
    "unbind", "split", "split_with_sizes", "narrow", "repeat",
    "repeat_interleave", "fill", "fill_", "zero_", "view_as_real",
    "view_as_complex", "scalar_tensor", "_local_scalar_dense", "tril",
    "triu", "unfold", "diagonal", "movedim", "masked_select", "nonzero"})
CONTROL_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "sort",
    "topk", "cumsum", "cumprod", "prod", "any", "all", "norm",
    "linalg_vector_norm", "_softmax", "softmax", "_log_softmax",
    "logsumexp", "var", "std", "var_mean", "searchsorted", "multinomial"})
COLLECTIVE_PREFIXES = ("all_reduce", "all_gather", "reduce_scatter",
                       "all_to_all", "broadcast_", "wait_tensor")

def op_class(op: str) -> str:
    """The class of one aten op (an ``overloadpacket`` name)."""
    if op.startswith(COLLECTIVE_PREFIXES):
        return "collective"
    if op in MATMUL_OPS:
        return "matmul"
    if op in ELEMENTWISE_OPS:
        return "elementwise"
    if op in MEMORY_OPS:
        return "memory_movement"
    if op in CONTROL_OPS:
        return "control"
    return "other"


def instruction_classes(hist: Dict[str, int]) -> Dict[str, int]:
    """Bucket an aten-op histogram into the paper's Fig 6 classes (the
    reference's six keys)."""
    buckets = dict.fromkeys(CLASSES, 0)
    for op, n in hist.items():
        buckets[op_class(op)] += n
    return buckets


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it, by ``func.overloadpacket``."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def op_histogram(fn: Callable, *args) -> Dict[str, int]:
    """The aten ops ``fn(*args)`` executes, counted by overload packet."""
    with OpCounter() as counter:
        fn(*args)
    return dict(counter.counts)


def _device_events(prof):
    """The names of the card's kernel records in a profile, without the
    copies and fills the runtime issues (``Memcpy``, ``Memset``), read
    from the raw Kineto records of the profile."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA and not name.startswith(
                ("Memcpy", "Memset")):
            yield name


class KernelRecorder:
    """``torch.profiler`` over a block of code on the card, recording the
    CUDA activity alone: ``hist`` is then the kernels the card ran in it,
    by name.  On the H100 (torch 2.11) its records were whole over short
    blocks early in a process, and not over a long eager loop nor in
    sessions opened after a long program and a compile, which recorded
    some of their kernels or none: a channel to calibrate, not to
    trust."""

    def __init__(self):
        self.hist: Dict[str, int] = {}
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.hist = dict(collections.Counter(
                _device_events(self._prof)))
        self._prof = None
        return False
