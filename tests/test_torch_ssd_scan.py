"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package on the CPU: the plain versions against the JAX oracle
(``ssd_ref.ssd_naive``), the Pallas op in interpret mode
(``repro.kernels.ssd_scan.ops.ssd_scan``) and the model's
``_ssd_chunked``, on the same numpy-seeded inputs.

The chunked form is the composition of the CUDA kernel's passes
(``chunk_states``, ``state_pass``, ``chunk_outputs``): the state before
each chunk is held against the JAX model's final state on the prefix up
to it (1e-5: the same recurrence summed alike), and the composition
against ``ssd_chunked`` bit for bit.

Tolerances: 2e-3 (rtol = atol) between the chunked and the token-by-token
forms and between the two packages' chunked forms, the JAX kernel test's
tolerance (tests/test_kernels_fused.py::test_ssd_scan): the same fp32
arithmetic summed in another order and grouping.  1e-5 between the two
token-by-token oracles, which sum in the same order.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro.models.mamba2 import _ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ops, ref

TOL = dict(rtol=2e-3, atol=2e-3)


def _softplus(a):
    return np.log1p(np.exp(a))


def _streams(seed, BH, S, P, N):
    """Stream-layout inputs as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((BH, S, P)).astype(f),
        dt=(_softplus(rng.standard_normal((BH, S, 1))) * 0.1).astype(f),
        B=(rng.standard_normal((BH, S, N)) * 0.5).astype(f),
        C=(rng.standard_normal((BH, S, N)) * 0.5).astype(f),
        A=(-np.exp(rng.standard_normal(BH))).astype(f),
        D=rng.standard_normal(BH).astype(f))


def _model(seed, b, S, h, P, N, dt_scale=0.1, a_scale=1.0):
    """Model-layout inputs: x (b,S,h,P), dt (b,S,h), B/C (b,S,N), A/D (h,)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, S, h, P)).astype(f),
        dt=(_softplus(rng.standard_normal((b, S, h))) * dt_scale).astype(f),
        A=(-np.exp(rng.standard_normal(h)) * a_scale).astype(f),
        B=(rng.standard_normal((b, S, N)) * 0.5).astype(f),
        C=(rng.standard_normal((b, S, N)) * 0.5).astype(f),
        D=rng.standard_normal(h).astype(f))


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("shape", [(4, 128, 16, 32), (2, 37, 64, 16),
                                   (3, 1, 32, 128)])
def test_naive_matches_jax_oracle(shape):
    d = _streams(0, *shape)
    got = ref.ssd_naive(**_t(d))
    want = jax_ssd_ref.ssd_naive(**_j(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", [(4, 128, 16, 32), (2, 256, 64, 16)])
def test_ssd_scan_matches_pallas_interpret(chunk, shape):
    """The JAX kernel test's shapes and chunks: the port's stream-layout
    op (plain version on the CPU) against the Pallas kernel in interpret
    mode and against the oracle."""
    d = _streams(4, *shape)
    got = ops.ssd_scan(**_t(d), chunk=chunk).numpy()
    want = np.asarray(jax_ssd_ops.ssd_scan(**_j(d), chunk=chunk,
                                           interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_ssd_ref.ssd_naive(**_j(d))), **TOL)


@pytest.mark.parametrize("S,chunk", [(1, 16), (37, 16), (128, 32),
                                     (200, 64), (64, 256)])
def test_ssd_chunked_matches_model_ssd(S, chunk):
    """``ref.ssd_chunked`` and the ``ops`` entry against the JAX model's
    ``_ssd_chunked``: y and the final state, S a multiple of the chunk and
    not, and a chunk longer than S."""
    d = _model(5, 2, S, 3, 16, 32)
    want_y, want_h = jax_ssd_chunked(**_j(d), chunk=chunk)
    for fn in (ref.ssd_chunked, ops.ssd_chunked):
        y, h = fn(**_t(d), chunk=chunk)
        assert y.shape == (2, S, 3, 16) and h.shape == (2, 3, 16, 32)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("P,N", [(16, 16), (32, 64), (64, 128)])
def test_ssd_chunked_matches_naive_per_stream(P, N):
    """Ragged S (200 over chunks of 64): the chunked form's y against the
    oracle run stream by stream; its final state against the recurrence
    ``h <- exp(dt A) h + dt B x^T`` run to the last token."""
    b, S, h = 2, 200, 2
    d = _model(6, b, S, h, P, N)
    y, hf = ref.ssd_chunked(**_t(d), chunk=64)
    x = np.moveaxis(d["x"], 2, 1).reshape(b * h, S, P)
    dt = np.moveaxis(d["dt"], 2, 1).reshape(b * h, S, 1)
    B = np.repeat(d["B"], h, axis=0)
    C = np.repeat(d["C"], h, axis=0)
    want = ref.ssd_naive(*map(torch.from_numpy, (
        x, dt, B, C, np.tile(d["A"], b), np.tile(d["D"], b))))
    got = y.permute(0, 2, 1, 3).reshape(b * h, S, P)
    torch.testing.assert_close(got, want, **TOL)
    state = np.zeros((b, h, P, N), np.float64)
    for t in range(S):
        dec = np.exp(d["dt"][:, t] * d["A"][None])            # (b, h)
        state = state * dec[..., None, None] + d["dt"][:, t, :, None, None] \
            * d["x"][:, t, :, :, None] * d["B"][:, t, None, None, :]
    np.testing.assert_allclose(hf.numpy(), state, **TOL)


def test_chunk_size_does_not_change_the_result():
    d = _t(_model(7, 1, 100, 2, 16, 16))
    y16, h16 = ref.ssd_chunked(**d, chunk=16)
    for chunk in (1, 7, 100, 256):
        y, h = ref.ssd_chunked(**d, chunk=chunk)
        torch.testing.assert_close(y, y16, **TOL)
        torch.testing.assert_close(h, h16, **TOL)


def test_gradient_matches_jax_and_stays_finite_past_overflow():
    """Train mode differentiates the plain version on the CPU.  At the
    JAX test's scales its gradients match ``jax.grad`` of the model's
    ``_ssd_chunked`` (2e-3).  With decays large enough that
    exp(cum_l - cum_m) overflows above the diagonal (|A| dt L > 88) the
    mask comes before the exp, so the gradient stays finite."""
    d = _model(8, 1, 48, 2, 16, 16)
    names = ("x", "dt", "A", "B", "C", "D")

    def jloss(*args):
        y, h = jax_ssd_chunked(*args, chunk=16)
        return (y ** 2).sum() + h.sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(d[k]) for k in names))
    ts = [torch.from_numpy(d[k]).requires_grad_() for k in names]
    y, h = ref.ssd_chunked(*ts, chunk=16)
    ((y ** 2).sum() + h.sum()).backward()
    for k, t, w in zip(names, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3, err_msg=k)

    big = _t(_model(9, 1, 64, 2, 16, 16, dt_scale=10.0, a_scale=20.0))
    for t in big.values():
        t.requires_grad_()
    y, h = ref.ssd_chunked(**big, chunk=64)
    ((y ** 2).sum() + h.sum()).backward()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert all(torch.isfinite(t.grad).all() for t in big.values())


def test_cpu_runs_the_plain_version_and_other_devices_the_kernel():
    """A CPU tensor never reaches the kernel (its counter stays); any
    other device goes to the kernel, which refuses a tensor that is not on
    a Hopper card — no fallback.  A call that needs a gradient off the
    CPU goes to the kernel too (``SSDChunked``'s forward), and raises
    there: the plain forward never stands in."""
    d = _t(_model(10, 1, 20, 2, 16, 16))
    before = K.ssd_scan_fwd.launches
    ops.ssd_chunked(**d, chunk=16)
    assert K.ssd_scan_fwd.launches == before
    meta = {k: v.to("meta") for k, v in d.items()}
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.ssd_chunked(**meta, chunk=16)
    meta["x"].requires_grad_()
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.ssd_chunked(**meta, chunk=16)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA device"):
        ops.ssd_chunked(**meta, chunk=16)
    assert K.ssd_scan_fwd.launches == before


@pytest.mark.parametrize("S,chunk", [(100, 16), (70, 32), (33, 32)])
def test_state_before_each_chunk_matches_jax_on_the_prefix(S, chunk):
    """``state_pass``' state before chunk c is the state after the first
    c * chunk tokens: the JAX model's ``h_final`` on that prefix (the first
    chunk's is zero); its final state is ``ssd_chunked``'s, S not a
    multiple of the chunk."""
    d = _model(11, 2, S, 3, 16, 32)
    t = _t(d)
    states = ref.chunk_states(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk)
    h_prev, h_final = ref.state_pass(states, t["dt"], t["A"], chunk)
    nc = -(-S // chunk)
    assert states.shape == h_prev.shape == (2, nc, 3, 16, 32)
    assert bool((h_prev[:, 0] == 0).all())
    for c in range(1, nc):
        pre = {k: (v[:, :c * chunk] if k in ("x", "dt", "B", "C") else v)
               for k, v in d.items()}
        _, want = jax_ssd_chunked(**_j(pre), chunk=chunk)
        np.testing.assert_allclose(h_prev[:, c].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5, err_msg=f"chunk {c}")
    _, want_final = jax_ssd_chunked(**_j(d), chunk=chunk)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(want_final),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(1, 16), (37, 16), (200, 64)])
def test_passes_compose_to_ssd_chunked(S, chunk):
    """``ssd_chunked`` is ``chunk_outputs`` after ``state_pass`` after
    ``chunk_states``, bit for bit: each pass is the kernel's oracle."""
    d = _t(_model(12, 2, S, 3, 16, 32))
    y, h = ref.ssd_chunked(**d, chunk=chunk)
    states = ref.chunk_states(d["x"], d["dt"], d["A"], d["B"], d["C"], chunk)
    h_prev, h_final = ref.state_pass(states, d["dt"], d["A"], chunk)
    assert torch.equal(h, h_final)
    assert torch.equal(y, ref.chunk_outputs(
        d["x"], d["dt"], d["A"], d["B"], d["C"], d["D"], h_prev, chunk))


def test_workspaces_at_the_layer_shape():
    """The binding's workspaces at mamba2-780m's layer (b 8, S 2048, 48
    heads, P 64, N 128, chunk 256): C.B^T 16.8 MB (it stays in the 50 MB
    L2), the states 100.7 MB; a chunk that is not a multiple of the tile
    pads to one."""
    ws = K.workspace_shapes(8, 2048, 48, 64, 128, 256)
    assert ws == {"cb": (8, 8, 256, 256), "cum": (8, 48, 8, 256),
                  "states": (8, 8, 48, 64, 128)}
    assert 4 * np.prod(ws["cb"]) == 16_777_216
    assert 4 * np.prod(ws["states"]) == 100_663_296
    assert K.workspace_shapes(1, 100, 2, 16, 16, 40)["cb"] == (1, 3, 64, 64)
    assert K.workspace_shapes(1, 0, 2, 16, 16, 16)["states"] == \
        (1, 0, 2, 16, 16)
