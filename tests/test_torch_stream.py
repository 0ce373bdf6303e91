"""The port's STREAM entry on the CPU (its plain version) against the JAX
package's ``stream`` (the Pallas kernel in interpret mode), on the same
numpy inputs: every kind, rows that are and are not a multiple of the
TPU's 8-row block.  fp32 throughout; the tolerance is fp32 roundoff
(1e-5)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stream import ops as jax_ops
from repro_torch.kernels.stream import kernel as pt_kernel
from repro_torch.kernels.stream import ops as pt_ops


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("kind", ["copy", "scale", "add", "triad"])
@pytest.mark.parametrize("shape", [(16, 128), (37, 128)])
@pytest.mark.parametrize("mult", [1, 4])
def test_stream_matches_jax(kind, shape, mult):
    x, y = _inputs(shape, seed=shape[0])
    got = pt_ops.stream(kind, torch.from_numpy(x), torch.from_numpy(y), 0.7,
                        block_multiplier=mult)
    want = jax_ops.stream(kind, jnp.asarray(x), jnp.asarray(y), 0.7,
                          block_multiplier=mult)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mult", [0, 1, 2, 3, 4, 8, 16])
def test_block_multiplier_validation_matches(mult):
    x, y = _inputs((16, 128), seed=1)
    outcomes = []
    for call in (lambda: jax_ops.stream("triad", jnp.asarray(x),
                                        jnp.asarray(y),
                                        block_multiplier=mult),
                 lambda: pt_ops.stream("triad", torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       block_multiplier=mult)):
        try:
            call()
            outcomes.append(None)
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


def test_unknown_kind_and_missing_y_raise():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        pt_ops.stream("fma", x, x)
    with pytest.raises(ValueError):
        pt_ops.stream("triad", x)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((8, 128))
    before = pt_kernel.stream_call.launches
    with pytest.raises(RuntimeError):
        pt_kernel.stream_call("triad", x, x)
    assert pt_kernel.stream_call.launches == before
