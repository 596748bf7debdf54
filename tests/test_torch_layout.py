"""The port's host-side substrate against the JAX package's, exactly.

Tile layout (``build_block_sparse`` exact and padded, then one shared
``apply_delta`` sequence through emptied tiles, a tile-pool bucket overflow,
a slot-table rewidening and an out-of-grid ``ValueError``), the numpy
helpers the port copies (generators, ``HostGraph``, batches, the delta
plan), the snapshot, and the frontier compaction.  Everything here is exact:
tile values are integer sums of ±1 and the rest is index bookkeeping, so
arrays must be equal, not close.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import delta as jdelta
from repro.core import frontier as jfr
from repro.core.graph import HostGraph as JHostGraph
from repro.core.incremental import effective_batch as j_effective_batch
from repro.core.pagerank import numpy_reference as j_numpy_reference
from repro.graphs import generators as jgen
from repro.kernels.block_spmv import ops as jops
from repro_torch.core import delta as tdelta
from repro_torch.core import frontier as tfr
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.incremental import effective_batch as t_effective_batch
from repro_torch.core.pagerank import numpy_reference as t_numpy_reference
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.block_spmv import ops as tops


def _same_mat(jm, tm):
    assert (tm.n_rows, tm.n_cols, tm.block, tm.max_tiles) == \
        (jm.n_rows, jm.n_cols, jm.block, jm.max_tiles)
    np.testing.assert_array_equal(tm.tiles.numpy(), np.asarray(jm.tiles))
    np.testing.assert_array_equal(tm.tile_cols.numpy(),
                                  np.asarray(jm.tile_cols))
    np.testing.assert_array_equal(tm.tile_idx.numpy(),
                                  np.asarray(jm.tile_idx))
    np.testing.assert_array_equal(tm.tile_cols_h, np.asarray(jm.tile_cols))
    np.testing.assert_array_equal(tm.tile_idx_h, np.asarray(jm.tile_idx))
    assert tm.n_tiles() == jm.n_tiles()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("block", [8, 32])
def test_build_block_sparse_equal(block, padded):
    rng = np.random.default_rng(block)
    rows, cols = rng.integers(0, 150, 900), rng.integers(0, 150, 900)
    jm = jops.build_block_sparse(rows, cols, 150, 150, block=block,
                                 dtype=np.float64, padded=padded)
    tm = tops.build_block_sparse(rows, cols, 150, 150, block=block,
                                 dtype=torch.float64, padded=padded,
                                 device="cpu")
    _same_mat(jm, tm)


def test_apply_delta_sequence_equal():
    """Same deltas, same layout after every step: a deletion that empties a
    tile (kept, all-zero), a batch that overflows the tile-pool bucket, one
    that overflows a row's slot bucket (rewidening), and an out-of-grid
    batch that raises on both sides."""
    n, B = 96, 8
    rows = np.array([0, 1, 9, 20, 40])
    cols = np.array([0, 2, 9, 30, 41])
    jm = jops.build_block_sparse(rows, cols, n, n, block=B, dtype=np.float64,
                                 padded=True)
    tm = tops.build_block_sparse(rows, cols, n, n, block=B,
                                 dtype=torch.float64, padded=True,
                                 device="cpu")
    _same_mat(jm, tm)
    cap0, mt0 = tm.tile_capacity, tm.max_tiles
    rng = np.random.default_rng(5)
    steps = [
        # empty the (2, 3) tile
        (np.array([20]), np.array([30]), np.array([-1.0])),
        # many new tiles in many rows: tile-pool bucket overflow
        (rng.integers(0, n, 40), rng.integers(0, n, 40), np.ones(40)),
        # every column-block in row-block 0: slot-table rewidening
        (np.zeros(12, np.int64), np.arange(12) * B, np.ones(12)),
        # add back the emptied entry and remove two others
        (np.array([20, 0, 9]), np.array([30, 0, 9]),
         np.array([1.0, -1.0, -1.0])),
    ]
    for r, c, v in steps:
        jm = jops.apply_delta(jm, r, c, v)
        tm = tops.apply_delta(tm, r, c, v)
        _same_mat(jm, tm)
    assert tm.tile_capacity > cap0 and tm.max_tiles > mt0
    for bad in ((np.array([n]), np.array([0])), (np.array([0]),
                                                 np.array([-1]))):
        with pytest.raises(ValueError, match="block grid"):
            jops.apply_delta(jm, *bad, np.ones(1))
        with pytest.raises(ValueError, match="block grid"):
            tops.apply_delta(tm, *bad, np.ones(1))


def test_apply_delta_patches_the_pool_in_place():
    """Within its capacity bucket the port patches the tile pool in place
    (the JAX version returns a new pool); the slot tables and the host twins
    move together."""
    n, B = 64, 8
    tm = tops.build_block_sparse(np.arange(10), np.arange(10), n, n, block=B,
                                 dtype=torch.float64, padded=True,
                                 device="cpu")
    pool = tm.tiles
    tm2 = tops.apply_delta(tm, np.array([3]), np.array([3]), np.array([1.0]))
    assert tm2.tiles is pool and float(pool[0, 3, 3]) == 2.0


def test_plan_delta_and_small_helpers_equal():
    n, B = 200, 16
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, n, 500), rng.integers(0, n, 500)
    jm = jops.build_block_sparse(rows, cols, n, n, block=B, padded=True)
    dr, dc = rng.integers(0, n, 60), rng.integers(0, n, 60)
    tc = np.asarray(jm.tile_cols)
    ti = np.asarray(jm.tile_idx).reshape(tc.shape)
    pj = jops.plan_delta(tc, ti, dr, dc, n_cb=jm.n_cb, block=B,
                         max_tiles=jm.max_tiles)
    pt = tops.plan_delta(tc, ti, dr, dc, n_cb=jm.n_cb, block=B,
                         max_tiles=jm.max_tiles)
    for f in ("tid", "tile_cols", "tile_idx", "touched_rb"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    assert (pt.n_old, pt.n_new, pt.max_tiles) == \
        (pj.n_old, pj.n_new, pj.max_tiles)
    for k in (1, 7, 8, 9, 1000):
        assert tops.capacity_bucket(k) == jops.capacity_bucket(k)
        assert tops.capacity_bucket(k, 4) == jops.capacity_bucket(k, 4)
        assert tops.active_ladder(k) == jops.active_ladder(k)
    with pytest.raises(OverflowError):
        tops.check_i32(2 ** 31, "tile")
    tm = tops.build_block_sparse(rows, cols, n, n, block=B, device="cpu")
    np.testing.assert_array_equal(tops.block_adjacency(tm).numpy(),
                                  np.asarray(jops.block_adjacency(
                                      jops.build_block_sparse(
                                          rows, cols, n, n, block=B))))


@pytest.mark.parametrize("name,args,kw", [
    ("rmat", (9,), {"avg_degree": 8, "seed": 3}),
    ("rmat", (10,), {"avg_degree": 4, "seed": 1, "chunk_edges": 1000}),
    ("erdos_renyi", (300,), {"avg_degree": 6, "seed": 2}),
    ("grid_road", (24,), {"seed": 7}),
])
def test_generators_give_the_same_edges(name, args, kw):
    jg = getattr(jgen, name)(*args, **kw)
    tg = getattr(tgen, name)(*args, **kw)
    assert tg.n == jg.n
    np.testing.assert_array_equal(tg.edges, jg.edges)


def test_host_graph_batches_and_snapshot_equal():
    jg = jgen.grid_road(20, seed=4)
    tg = THostGraph(jg.n, jg.edges)
    for seed in range(3):
        dj = jdelta.random_batch(jg, 0.02, seed=seed, deletions_frac=0.3)
        dt = tdelta.random_batch(tg, 0.02, seed=seed, deletions_frac=0.3)
        for a, b in zip(dj, dt):
            np.testing.assert_array_equal(a, b)
        dels, ins = dj
        # one re-insertion and one absent deletion exercise the netting
        dels = np.concatenate([dels, [[0, 399]]])
        ins = np.concatenate([ins, dels[:1]])
        for a, b in zip(j_effective_batch(jg, dels, ins),
                        t_effective_batch(tg, dels, ins)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jdelta.signed_edge_delta(*dj),
                        tdelta.signed_edge_delta(*dt)):
            np.testing.assert_array_equal(a, b)
        jg, tg = jg.apply_batch(*dj), tg.apply_batch(*dt)
        np.testing.assert_array_equal(tg.edges, jg.edges)
        np.testing.assert_array_equal(tg.has_edges(dj[1]),
                                      jg.has_edges(dj[1]))
    gj = jg.snapshot(block_size=32)
    gt = tg.snapshot(block_size=32, device="cpu")
    assert (gt.n, gt.m, gt.block_size, gt.n_blocks) == \
        (gj.n, gj.m, gj.block_size, gj.n_blocks)
    for f in ("src", "dst", "in_block_ptr", "osrc", "odst", "out_block_ptr",
              "out_deg", "vertex_valid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)))
    np.testing.assert_array_equal(gt.block_in_edges().numpy(),
                                  np.asarray(gj.block_in_edges()))
    np.testing.assert_array_equal(t_numpy_reference(gt, iterations=50),
                                  j_numpy_reference(gj, iterations=50))


@pytest.mark.parametrize("bad", [
    ([[0, 1], [0, 1]], []),             # duplicate deletion
    ([], [[2, 2]]),                     # self-loop insertion
    ([[0, 1]], [[0, 1]]),               # in both sides
    ([], [[0, 10 ** 6]]),               # out of range
    ([], [[0.5, 1.0]]),                 # fractional id
])
def test_validate_edge_batch_rejects_alike(bad):
    with pytest.raises(ValueError):
        jdelta.validate_edge_batch(*bad, 100)
    with pytest.raises(ValueError):
        tdelta.validate_edge_batch(*bad, 100)


def test_frontier_helpers_equal():
    rng = np.random.default_rng(8)
    for n_blocks in (1, 5, 64):
        for p in (0.0, 0.3, 1.0):
            act = rng.random(n_blocks) < p
            np.testing.assert_array_equal(
                tfr.compact_block_ids(torch.from_numpy(act), n_blocks)
                .numpy(),
                np.asarray(jfr.compact_block_ids(jnp.asarray(act),
                                                 n_blocks)))
    flags = rng.random(4 * 16 + 5) < 0.05
    np.testing.assert_array_equal(
        tfr.block_any(torch.from_numpy(flags), 4, 16).numpy(),
        np.asarray(jfr.block_any(jnp.asarray(flags), 4, 16)))
    dels, ins = np.array([[1, 2]]), np.array([[3, 4], [5, 6]])
    np.testing.assert_array_equal(
        tfr.pack_batch(64, dels, ins, device="cpu").numpy(),
        np.asarray(jfr.pack_batch(64, dels, ins)))


@pytest.mark.parametrize("dels,ins", [
    ([], [[3, 4], [3, 4], [4, 3]]),        # duplicate insertion
    ([[0, 1], [9, 8]], []),                # one present, one absent
    ([[0, 1]], [[0, 1], [5, 5]]),          # delete + re-insert; self-loop
    ([[0, 1], [1, 0]], [[7, 2]]),
])
@pytest.mark.parametrize("start", [[[0, 1], [1, 0], [2, 3]], []])
def test_apply_batch_edge_cases_equal(start, dels, ins):
    """``HostGraph.apply_batch`` (binary-search form in the port) gives the
    JAX package's edge set, also from an empty graph."""
    jg = JHostGraph(10, np.array(start).reshape(-1, 2))
    tg = THostGraph(10, np.array(start).reshape(-1, 2))
    d, i = np.array(dels).reshape(-1, 2), np.array(ins).reshape(-1, 2)
    np.testing.assert_array_equal(tg.apply_batch(d, i).edges,
                                  jg.apply_batch(d, i).edges)
