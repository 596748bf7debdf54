"""The port's tile-SpMV kernels against the JAX package's on the same tiles.

Inputs are made with numpy from a seed; the JAX matrix is built by
``repro.kernels.block_spmv.ops.build_block_sparse`` and handed to the port
unchanged through ``repro_torch.convert.block_sparse_from_numpy``, so both
sides multiply identical tiles.  On the CPU the port runs each kernel's plain
version; the JAX side runs its XLA tile backend, plus one small case per
kernel through the Pallas kernel in interpret mode.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances (as ``tests/test_kernels.py``): f32 2e-5 and bf16 3e-2 — the two
sides sum in different orders in f32; f64 1e-12 — different summation
orders in f64 over ≤ 128·max_tiles terms of size ≤ 1.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.block_spmv import ops as jops
from repro.kernels.block_spmv.block_spmv import (block_spmv_pallas,
                                                 block_spmv_active_pallas)
from repro_torch.convert import block_sparse_from_numpy
from repro_torch.kernels.block_spmv import block_spmv as bsk
from repro_torch.kernels.block_spmv import ops as tops
from repro_torch.kernels.block_spmv import ref as tref

# f32 products stay IEEE on the card (no TF32), as in the JAX tests
torch.backends.cuda.matmul.allow_tf32 = False

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "float64": (np.float64, jnp.float64, torch.float64, 1e-12),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16, 3e-2)}


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def _pair(rows, cols, n, block, dtype, padded, values=None):
    """(JAX BlockSparse, port BlockSparse) over the same tiles."""
    np_dt, j_dt, t_dt, _ = DTYPES[dtype]
    jm = jops.build_block_sparse(rows, cols, n, n, block=block, dtype=np_dt,
                                 padded=padded, values=values)
    tm = block_sparse_from_numpy(np.asarray(jm.tiles),
                                 np.asarray(jm.tile_cols),
                                 np.asarray(jm.tile_idx), n, n, block,
                                 device="cpu")
    if dtype == "bfloat16":      # numpy has no bf16: round both sides alike
        jm = jm.__class__(**{**jm.__dict__, "tiles": jm.tiles.astype(j_dt)})
        tm = dataclasses.replace(tm, tiles=tm.tiles.to(t_dt))
    return jm, tm


def _x(n, dtype, seed, semiring):
    x = np.random.default_rng(seed).random(n)
    if semiring == "or":
        x = (x < 0.15).astype(np.float64)
    _, j_dt, t_dt, _ = DTYPES[dtype]
    return jnp.asarray(x, j_dt), torch.from_numpy(x).to(t_dt)


def _close(y_port, y_jax, tol):
    np.testing.assert_allclose(
        y_port.to(torch.float64).numpy(),
        np.asarray(y_jax.astype(jnp.float64)), rtol=tol, atol=tol)


@pytest.mark.parametrize("semiring", ["sum", "or"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("block", [8, 32, 64, 128])
def test_block_spmv_matches_jax(block, dtype, semiring):
    n = 300
    rows, cols = _edges(n, 3000, seed=block)
    jm, tm = _pair(rows, cols, n, block, dtype, padded=False)
    xj, xt = _x(n, dtype, block + 1, semiring)
    yj = jops.block_spmv(jm, xj, semiring=semiring, backend="xla")
    yt = tops.block_spmv(tm, xt, semiring=semiring)
    _close(yt, yj, DTYPES[dtype][3])


@pytest.mark.parametrize("semiring", ["sum", "or"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("block", [8, 32, 64, 128])
def test_block_spmv_active_matches_jax(block, dtype, semiring):
    """Active list: a random subset of row-blocks first, then −1 padding;
    only the listed blocks' rows are compared (the rest are undefined)."""
    n = 400
    rows, cols = _edges(n, 4000, seed=block + 7)
    jm, tm = _pair(rows, cols, n, block, dtype, padded=True)
    xj, xt = _x(n, dtype, block + 2, semiring)
    rng = np.random.default_rng(block)
    act = np.flatnonzero(rng.random(jm.n_rb) < 0.5)
    ids = np.full(jm.n_rb, -1, np.int32)
    ids[:len(act)] = act
    yj = jops.block_spmv_active(jm, xj, jnp.asarray(ids), semiring=semiring,
                                backend="xla")
    yt = tops.block_spmv_active(tm, xt, torch.from_numpy(ids),
                                semiring=semiring)
    rows_act = (act[:, None] * block + np.arange(block)).reshape(-1)
    rows_act = rows_act[rows_act < n]
    _close(yt[rows_act], yj[rows_act], DTYPES[dtype][3])


@pytest.mark.parametrize("block", [16, 64])
def test_padded_layout_matches_exact(block):
    """Capacity-padded and exact layouts compute the same product, and both
    match the edge-list oracle."""
    n = 300
    rows, cols = _edges(n, 3000, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).random(n))
    exact = tops.build_block_sparse(rows, cols, n, n, block=block,
                                    dtype=torch.float64, device="cpu")
    padded = tops.build_block_sparse(rows, cols, n, n, block=block,
                                     dtype=torch.float64, padded=True,
                                     device="cpu")
    assert padded.tile_capacity >= exact.tile_capacity
    assert padded.max_tiles >= exact.max_tiles
    y_e, y_p = tops.block_spmv(exact, x), tops.block_spmv(padded, x)
    torch.testing.assert_close(y_p, y_e, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(y_e, tref.spmv_ref(rows, cols, n, x),
                               rtol=1e-12, atol=1e-12)


def test_or_semiring_weighted_is_normalized():
    """OR gives a 0/1 indicator even for fractional tile values, on the full
    and the active variant, and the indicator equals the JAX package's."""
    n = 200
    rows, cols = _edges(n, 1200, seed=12)
    vals = np.full(1200, 0.3, np.float32)
    jm, tm = _pair(rows, cols, n, 32, "float32", padded=False, values=vals)
    xj, xt = _x(n, "float32", 13, "or")
    y = tops.block_spmv(tm, xt, semiring="or")
    assert bool(((y == 0) | (y == 1)).all())
    ids = torch.arange(tm.n_rb, dtype=torch.int32)
    ya = tops.block_spmv_active(tm, xt, ids, semiring="or")
    yb = tops.block_spmv_active_bucketed(tm, xt, ids, torch.tensor(tm.n_rb),
                                         semiring="or")
    assert torch.equal(ya, y) and torch.equal(yb, y)
    yj = jops.block_spmv(jm, xj, semiring="or", backend="xla")
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


@pytest.mark.parametrize("semiring", ["sum", "or"])
def test_plain_kernels_match_pallas_interpret(semiring):
    """One small case per kernel through the TPU kernels themselves
    (``block_spmv_pallas`` / ``block_spmv_active_pallas`` in interpret
    mode), f32 at 2e-5; the active list has its −1 padding in the middle of
    the buffer's tail."""
    n, B = 96, 32
    rows, cols = _edges(n, 500, seed=21)
    jm, tm = _pair(rows, cols, n, B, "float32", padded=True)
    xj, xt = _x(n, "float32", 22, semiring)
    yj = block_spmv_pallas(jm.tile_idx, jm.tile_cols, jm.tiles, xj,
                           block=B, max_tiles=jm.max_tiles,
                           semiring=semiring, interpret=True)
    yt = bsk.block_spmv_plain(tm.tile_idx, tm.tile_cols, tm.tiles, xt,
                              block=B, max_tiles=tm.max_tiles,
                              semiring=semiring)
    _close(yt, yj, 2e-5)
    ids = np.array([2, 0, -1], np.int32)
    yja = block_spmv_active_pallas(jnp.asarray(ids), jm.tile_idx,
                                   jm.tile_cols, jm.tiles, xj, block=B,
                                   max_tiles=jm.max_tiles, semiring=semiring,
                                   interpret=True)
    yta = bsk.block_spmv_active_plain(torch.from_numpy(ids), tm.tile_idx,
                                      tm.tile_cols, tm.tiles, xt, block=B,
                                      max_tiles=tm.max_tiles,
                                      semiring=semiring)
    rows_act = np.r_[0:B, 2 * B:3 * B]
    _close(yta[rows_act], yja[rows_act], 2e-5)


def test_empty_slots_anywhere_in_the_row():
    """A −1 slot before a live one contributes nothing (the slot tables
    after ``apply_delta`` need not keep −1 entries trailing)."""
    n, B = 256, 8
    rows, cols = _edges(n, 150, seed=31)
    tm = tops.build_block_sparse(rows, cols, n, n, block=B,
                                 dtype=torch.float64, padded=True,
                                 device="cpu")
    x = torch.from_numpy(np.random.default_rng(32).random(n))
    y0 = tops.block_spmv(tm, x)
    cols_t = tm.tile_cols.clone().reshape(tm.n_rb, tm.max_tiles)
    idx_t = tm.tile_idx.clone().reshape(tm.n_rb, tm.max_tiles)
    perm = torch.arange(tm.max_tiles).flip(0)          # −1 slots first
    moved = tops.BlockSparse(
        n_rows=n, n_cols=n, block=B, max_tiles=tm.max_tiles, tiles=tm.tiles,
        tile_cols=cols_t[:, perm].contiguous(),
        tile_idx=idx_t[:, perm].reshape(-1).contiguous(),
        tile_cols_h=cols_t[:, perm].numpy(),
        tile_idx_h=idx_t[:, perm].reshape(-1).numpy())
    assert bool((moved.tile_cols[:, 0] < 0).any())
    torch.testing.assert_close(tops.block_spmv(moved, x), y0, rtol=1e-12,
                               atol=1e-12)


def test_pull_step_and_expand_match_jax():
    """``pagerank_pull_step`` and ``frontier_expand_op`` (f64) against the
    JAX package's on the same pull matrix."""
    n = 500
    src, dst = _edges(n, 4000, seed=9)
    jm, tm = _pair(dst, src, n, 64, "float64", padded=False)
    out_deg = np.maximum(np.bincount(src, minlength=n), 1)
    r = np.random.default_rng(9).random(n)
    r /= r.sum()
    yj = jops.pagerank_pull_step(jm, jnp.asarray(r), jnp.asarray(1.0 / out_deg),
                                 n, backend="xla")
    yt = tops.pagerank_pull_step(tm, torch.from_numpy(r),
                                 torch.from_numpy(1.0 / out_deg), n)
    _close(yt, yj, 1e-12)
    flags = np.random.default_rng(10).random(n) < 0.07
    ej = jops.frontier_expand_op(jm, jnp.asarray(flags), backend="xla")
    et = tops.frontier_expand_op(tm, torch.from_numpy(flags))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_cpu_tensors_take_the_plain_version():
    """The dispatcher sends CPU tensors to the plain version (no launch is
    counted) and the CUDA wrappers refuse CPU tensors."""
    n, B = 64, 16
    rows, cols = _edges(n, 200, seed=41)
    tm = tops.build_block_sparse(rows, cols, n, n, block=B, device="cpu")
    x = torch.ones(n)
    before = (bsk.block_spmv_cuda.launches,
              bsk.block_spmv_active_cuda.launches)
    tops.block_spmv(tm, x)
    tops.block_spmv_active(tm, x, torch.arange(tm.n_rb, dtype=torch.int32))
    assert (bsk.block_spmv_cuda.launches,
            bsk.block_spmv_active_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA device"):
        bsk.block_spmv_cuda(tm.tile_idx, tm.tile_cols, tm.tiles, x, block=B,
                            max_tiles=tm.max_tiles)
    with pytest.raises(ValueError, match="CUDA device"):
        bsk.block_spmv_active_cuda(torch.arange(tm.n_rb, dtype=torch.int32),
                                   tm.tile_idx, tm.tile_cols, tm.tiles, x,
                                   block=B, max_tiles=tm.max_tiles)
