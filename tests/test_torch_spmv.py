"""The port's ELL SpMV on the CPU (its plain versions) against the JAX
package's ``spmv_ell`` (the Pallas kernels in interpret mode), in both
idioms (take and one-hot), on the same numpy matrices: rows that are and
are not a multiple of the TPU's 8-row block, and nonzeros per row that
are not a power of two.  A column outside [0, C) contributes 0 in the
one-hot idiom, as in the JAX one-hot kernel.  fp32; the tolerance is
fp32 roundoff of a <= 16-term sum (1e-5)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.spmv import ops as jax_ops
from repro.kernels.spmv import ref as jax_ref
from repro_torch.kernels.spmv import kernel as pt_kernel
from repro_torch.kernels.spmv import ops as pt_ops
from repro_torch.kernels.spmv import ref as pt_ref


@pytest.mark.parametrize("idiom", ["take", "onehot"])
@pytest.mark.parametrize("rows,cols,nnz", [(64, 256, 16), (100, 77, 13),
                                           (9, 512, 1)])
def test_spmv_matches_jax(rows, cols, nnz, idiom):
    vals, idx = pt_ref.random_ell(rows, rows, cols, nnz)
    x = np.random.default_rng(2).standard_normal(cols).astype(np.float32)
    got = pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                          torch.from_numpy(x), idiom=idiom)
    want = jax_ops.spmv_ell(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(x), idiom=idiom)
    assert got.shape == (rows, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rows,cols,nnz", [(64, 256, 16), (37, 50, 5)])
def test_onehot_out_of_range_columns_contribute_zero(rows, cols, nnz):
    """Columns at -1 and at C against the JAX one-hot kernel; each row's
    sum then equals the take idiom's over its in-range nonzeros."""
    vals, idx = pt_ref.random_ell(rows + 1, rows, cols, nnz)
    idx[::3, 0] = -1
    idx[1::3, -1] = cols
    x = np.random.default_rng(3).standard_normal(cols).astype(np.float32)
    got = pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                          torch.from_numpy(x), idiom="onehot")
    want = jax_ops.spmv_ell(jnp.asarray(vals), jnp.asarray(idx),
                            jnp.asarray(x), idiom="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    inside = (idx >= 0) & (idx < cols)
    kept = np.where(inside, vals, 0.0).astype(np.float32)
    take = pt_ops.spmv_ell(torch.from_numpy(kept),
                           torch.from_numpy(np.where(inside, idx, 0)
                                            .astype(np.int32)),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), take.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_random_ell_is_the_reference_helper():
    for a, b in zip(pt_ref.random_ell(4, 33, 70, 5),
                    jax_ref.random_ell(4, 33, 70, 5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mult", [0, 1, 3, 8, 16])
def test_block_multiplier_validation_matches(mult):
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    x = np.ones(32, np.float32)
    outcomes = []
    for call in (lambda: jax_ops.spmv_ell(jnp.asarray(vals),
                                          jnp.asarray(idx), jnp.asarray(x),
                                          block_multiplier=mult),
                 lambda: pt_ops.spmv_ell(torch.from_numpy(vals),
                                         torch.from_numpy(idx),
                                         torch.from_numpy(x),
                                         block_multiplier=mult)):
        try:
            call()
            outcomes.append(None)
        except ValueError:
            outcomes.append(ValueError)
    assert outcomes[0] == outcomes[1]


def test_unknown_idiom_raises():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    with pytest.raises(ValueError):
        pt_ops.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                        torch.ones(32), idiom="gather")


@pytest.mark.parametrize("idiom,wrapper", [("take", "spmv_ell"),
                                           ("onehot", "spmv_ell_onehot")])
def test_non_cpu_tensor_launches_the_kernel_or_raises(monkeypatch, idiom,
                                                      wrapper):
    class Launched(Exception):
        pass

    def launched(*args, **kwargs):
        raise Launched

    monkeypatch.setattr(pt_kernel, wrapper, launched)
    for name in ("spmv_ell", "spmv_ell_onehot"):
        monkeypatch.setattr(pt_ref, name, launched)
    vals = torch.zeros((16, 4), device="meta")
    with pytest.raises(Launched):
        pt_ops.spmv_ell(vals, torch.zeros((16, 4), dtype=torch.int32,
                                          device="meta"),
                        torch.zeros(32, device="meta"), idiom=idiom)


def test_kernel_wrapper_refuses_cpu_tensors():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    before = pt_kernel.spmv_ell.launches
    with pytest.raises(RuntimeError):
        pt_kernel.spmv_ell(torch.from_numpy(vals), torch.from_numpy(idx),
                           torch.ones(32))
    assert pt_kernel.spmv_ell.launches == before


def test_onehot_kernel_wrapper_refuses_cpu_tensors():
    vals, idx = pt_ref.random_ell(0, 16, 32, 4)
    before = pt_kernel.spmv_ell_onehot.launches
    with pytest.raises(RuntimeError):
        pt_kernel.spmv_ell_onehot(torch.from_numpy(vals),
                                  torch.from_numpy(idx), torch.ones(32))
    assert pt_kernel.spmv_ell_onehot.launches == before


@pytest.mark.parametrize("K", [0, 1, 2, 3, 5, 8, 9, 16, 17, 33, 100, 257])
@pytest.mark.parametrize("C", [1, 77, 20000])
def test_onehot_plan_covers_k_and_c(K, C):
    """The one-hot kernel's plan: a power-of-two count of lanes a row (at
    most 32), four nonzeros a lane where K > 4 (one broadcast of x feeds
    sixteen compare-selects), enough passes for every nonzero, and x staged
    in chunks of a multiple of 4 floats, at most 16384 (64 KB), the whole
    of C where it fits."""
    lanes, per_lane, passes, chunk = pt_kernel.onehot_plan(K, C)
    assert lanes in (1, 2, 4, 8, 16, 32) and per_lane in (1, 2, 4)
    assert per_lane == pt_kernel.ONEHOT_PER_LANE or lanes == 1
    assert lanes * per_lane * passes >= K
    assert K == 0 or lanes * per_lane * (passes - 1) < K or passes == 1
    assert chunk % 4 == 0 and 4 <= chunk <= pt_kernel.ONEHOT_X_CHUNK
    assert chunk >= C or chunk == pt_kernel.ONEHOT_X_CHUNK



SMS = 132                 # an H100 SXM's SMs


def _rows_covered(plan, R):
    """How many times each row is taken: every tile t of ``tile_rows``
    rows, the vector path's block b walking tiles b, b + grid, ... as
    csrc/spmv.cu does, the general path's block b its one tile."""
    tiles = -(-R // plan.tile_rows)
    if plan.path == "vector":
        walk = np.arange(plan.grid)[:, None] + plan.grid * np.arange(
            -(-tiles // plan.grid) + 1)[None, :]
        taken = walk[walk < tiles]
    else:
        taken = np.arange(plan.grid)
    counts = np.zeros(tiles + 1, np.int64)
    np.add.at(counts, np.minimum(taken, tiles), 1)
    assert counts[tiles] == 0 or plan.path == "general"
    per_tile = counts[:tiles]
    rows = np.minimum(plan.tile_rows, R - np.arange(tiles) * plan.tile_rows)
    return per_tile, rows


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
@pytest.mark.parametrize("R", [0, 1, 1000, 1 << 22])
@pytest.mark.parametrize("K", [1, 4, 13, 16, 17, 32, 64])
def test_take_plan_covers_rows_and_fits(K, R, mult, aligned):
    """The take kernel's plan: the vector path applies only for K a
    multiple of 4 with aligned operands (lanes the power of two at or
    above K / 4) and is the plan's where some block walks a second tile,
    else the general path (lanes the power of two at or above K, at most
    32); on either path the tiles take every row exactly once; the
    persistent grid is never more than ``sms`` x its blocks a SM, each
    block's ring fits 227 KB and the blocks of an SM the shared-memory
    budget."""
    plan = pt_kernel.take_plan(R, K, mult, SMS, aligned)
    general = pt_kernel.take_plan(R, K, mult, SMS, aligned, "general")
    plans = [general]
    if K % 4 == 0 and aligned:
        vector = pt_kernel.take_plan(R, K, mult, SMS, aligned, "vector")
        plans.append(vector)
        assert plan == (vector if -(-R // vector.tile_rows) > vector.grid
                        else general)
        assert plan.path == ("vector" if R == 1 << 22 else "general")
    else:
        with pytest.raises(ValueError):
            pt_kernel.take_plan(R, K, mult, SMS, aligned, "vector")
        assert plan == general
    for p in plans:
        per_tile, rows = _rows_covered(p, R)
        assert (per_tile == 1).all() and rows.sum() == R and (rows > 0).all()
    assert general.lanes == min(1 << max(K - 1, 0).bit_length(), 32)
    assert general.tile_rows == 256 // general.lanes * mult
    assert general.stages == general.smem == 0
    if len(plans) == 2:
        assert vector.lanes == min(1 << (K // 4 - 1).bit_length(), 32)
        assert vector.tile_rows == pt_kernel.TAKE_CONSUMERS // vector.lanes \
            * mult
        assert 1 <= vector.grid <= SMS * vector.blocks_per_sm
        assert vector.grid == max(min(-(-R // vector.tile_rows),
                                      SMS * vector.blocks_per_sm), 1)
        assert 2 <= vector.stages <= pt_kernel.TAKE_MAX_STAGES
        assert vector.smem == pt_kernel.take_smem_bytes(
            K, vector.lanes, mult, vector.stages)
        assert vector.smem <= 227 * 1024
        assert vector.blocks_per_sm * (vector.smem + 1024) <= 132 * 1024
        assert 1 <= vector.blocks_per_sm <= \
            pt_kernel.TAKE_BLOCKS_PER_SM[mult]


@pytest.mark.parametrize("K,mult,path", [(128, 8, "vector"),
                                         (256, 8, "general"),
                                         (1024, 1, "vector"),
                                         (1024, 2, "general"),
                                         (4096, 1, "general")])
def test_take_plan_takes_the_general_path_where_the_ring_overflows(
        K, mult, path):
    """Two stages of a tile that do not fit 227 KB leave the vector path
    for the general one (and forcing it raises)."""
    plan = pt_kernel.take_plan(1 << 20, K, mult, SMS, True)
    assert plan.path == path
    if path == "vector":
        assert plan.smem <= 227 * 1024 and plan.stages >= 2
    else:
        with pytest.raises(ValueError):
            pt_kernel.take_plan(1 << 20, K, mult, SMS, True, "vector")


def test_take_plan_refuses_a_bad_multiplier_or_path():
    with pytest.raises(ValueError):
        pt_kernel.take_plan(1000, 16, 3, SMS, True)
    with pytest.raises(ValueError):
        pt_kernel.take_plan(1000, 16, 1, SMS, True, "scalar")


def test_take_constants_match_the_source():
    """The plan's constants are the CUDA source's: consumer threads, the
    most stages, a block's shared memory, the ring's bytes and the blocks
    a SM the kernel's ``__launch_bounds__`` holds its registers to."""
    src = pt_kernel.SOURCES[0].read_text()

    def const(name):
        return src.split(f"constexpr int {name} = ")[1].split(";")[0]

    assert int(const("kTakeConsumers")) == pt_kernel.TAKE_CONSUMERS
    assert int(const("kTakeMaxStages")) == pt_kernel.TAKE_MAX_STAGES
    assert eval(const("kTakeSmemLimit")) == pt_kernel.TAKE_SMEM_LIMIT
    assert int(const("kBlockReserved")) == pt_kernel.BLOCK_RESERVED
    bounds = src.split("return rpg == 1 ? ")[1].split(";")[0]
    b = pt_kernel.TAKE_BLOCKS_PER_SM
    assert bounds == f"{b[1]} : rpg == 2 ? {b[2]} : rpg == 4 ? {b[4]} : {b[8]}"
    ring = src.split("return stages * (")[1].split(";")[0]
    assert ring == "2 * (kTakeConsumers / lanes) * rpg * K * 4 + 16)"
