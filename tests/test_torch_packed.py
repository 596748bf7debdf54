"""The packed nonzero index beside the port's tile pool (``ops.PackedIndex``),
the operand of the CUDA tile-SpMV kernels.

(a) a built index equals a numpy derivation from the dense tiles;
(b) after every step of a delta sequence, and over a long random stream
    that compacts, the index ``apply_delta`` refreshed equals a fresh build,
    tile by tile (same entries, same order);
(c) a plain reading of the index, kept here and shaped like the kernels'
    arithmetic (threads own rows, slot by slot), equals the plain versions
    over the dense tiles in both semirings, weighted tiles included;
(d) the refresh reads nothing back from the device.

All on the CPU, inputs from numpy seeds.  Index bookkeeping is exact, so
(a) and (b) compare arrays for equality.  (c) uses the tolerances of
``tests/test_kernels.py`` (f32 2e-5, f64 1e-12): the two sides sum in
different orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_spmv import block_spmv as bsk
from repro_torch.kernels.block_spmv import ops as tops

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def _tile_entries(index, t, B):
    """(rows, cols, values as f64) of tile t's packed entries, in order."""
    off, cnt = int(index.off[t]), int(index.cnt[t])
    rows = index.row[off:off + cnt].to(torch.int64).numpy()
    cols = index.col[off:off + cnt].to(torch.int64).numpy()
    vals = index.val[off:off + cnt].to(torch.float64).numpy()
    assert ((rows < B) & (cols < B)).all()
    return rows, cols, vals


def _numpy_entries(tiles, t):
    T = tiles[t].to(torch.float64).numpy()
    r, c = np.nonzero(T)                  # row-major, as the index keeps them
    return r, c, T[r, c]


def _check_index(mat):
    """Every tile's packed entries against the dense tile; the live ranges
    are disjoint, below the tail, and within each tile's host bound."""
    index, B = mat.index, mat.block
    cap = mat.tile_capacity
    assert index.off.shape == index.cnt.shape == (cap,)
    ranges = []
    for t in range(cap):
        got = _tile_entries(index, t, B)
        want = _numpy_entries(mat.tiles, t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        cnt = int(index.cnt[t])
        assert cnt <= index.bound_h[t]
        if cnt:
            ranges.append((int(index.off[t]), int(index.off[t]) + cnt))
    ranges.sort()
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 <= b0
    assert not ranges or ranges[-1][1] <= index.tail <= index.entry_capacity


def _same_as_fresh_build(mat):
    """The refreshed index against ``build_index`` of the same pool, tile by
    tile: same entries in the same order."""
    fresh = tops.build_index(mat.tiles)
    for t in range(mat.tile_capacity):
        for g, w in zip(_tile_entries(mat.index, t, mat.block),
                        _tile_entries(fresh, t, mat.block)):
            np.testing.assert_array_equal(g, w)


def _weighted(rng, m):
    """Edge weights with repeats that cancel, so some stored positions of
    live tiles sum to zero and must not be packed."""
    return rng.choice([-2.0, -1.0, 0.5, 1.0, 3.0], size=m)


# ---------------------------------------------------------------------------
# (a) built index == numpy derivation from the tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("block", [8, 32, 64, 128])
def test_built_index_equals_numpy_derivation(block, dtype, padded):
    n = 260
    rng = np.random.default_rng(block)
    rows, cols = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    rows = np.concatenate([rows, rows[:200]])     # duplicates: some cancel
    cols = np.concatenate([cols, cols[:200]])
    vals = _weighted(rng, len(rows))
    mat = tops.build_block_sparse(rows, cols, n, n, block=block,
                                  values=vals, dtype=DTYPES[dtype],
                                  padded=padded, device="cpu")
    assert mat.index.val.dtype == DTYPES[dtype]
    assert int(mat.index.cnt.sum()) == mat.index.tail == \
        int((mat.tiles != 0).sum())
    _check_index(mat)


def test_block_sparse_built_by_hand_carries_an_index():
    """A ``BlockSparse`` constructed without an index builds one from its
    tiles; ``dataclasses.replace`` carries the index it is given."""
    n, B = 64, 8
    m = tops.build_block_sparse(np.arange(20), np.arange(20)[::-1], n, n,
                                block=B, device="cpu")
    bare = tops.BlockSparse(
        n_rows=n, n_cols=n, block=B, max_tiles=m.max_tiles, tiles=m.tiles,
        tile_cols=m.tile_cols, tile_idx=m.tile_idx,
        tile_cols_h=m.tile_cols_h, tile_idx_h=m.tile_idx_h)
    _check_index(bare)
    assert bare.index is not m.index


# ---------------------------------------------------------------------------
# (b) refreshed index == fresh build after every delta
# ---------------------------------------------------------------------------

@pytest.fixture
def count_builds(monkeypatch):
    calls = []
    real = tops.build_index

    def counted(tiles):
        calls.append(tiles.shape[0])
        return real(tiles)

    monkeypatch.setattr(tops, "build_index", counted)
    return calls


def test_refresh_through_the_delta_sequence(count_builds):
    """The sequence of ``test_torch_layout.test_apply_delta_sequence_equal``
    plus a zero-value delta (as ``warmup`` makes): after each step the
    refreshed index equals a fresh build and the dense tiles, and no step
    rebuilt it."""
    n, B = 96, 8
    rows = np.array([0, 1, 9, 20, 40])
    cols = np.array([0, 2, 9, 30, 41])
    mat = tops.build_block_sparse(rows, cols, n, n, block=B,
                                  dtype=torch.float64, padded=True,
                                  device="cpu")
    cap0, mt0 = mat.tile_capacity, mat.max_tiles
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
        # a zero-value delta on vertex 0's tile, as warmup makes
        (np.zeros(1, np.int64), np.zeros(1, np.int64), np.zeros(1)),
    ]
    for r, c, v in steps:
        count_builds.clear()
        mat = tops.apply_delta(mat, r, c, v)
        assert count_builds == []
        _check_index(mat)
        _same_as_fresh_build(mat)
    assert mat.tile_capacity > cap0 and mat.max_tiles > mt0
    emptied = int(mat.tile_idx_h.reshape(mat.n_rb, -1)[2][
        list(mat.tile_cols_h[2]).index(3)])
    assert int(mat.index.cnt[emptied]) == 1       # emptied, then refilled


def test_long_random_stream_compacts(count_builds):
    """A long stream of random insert/delete batches runs the tail out of
    room at least once; the compaction rebuilds the index whole, and after
    every batch the index equals a fresh build."""
    n, B = 128, 8
    rng = np.random.default_rng(11)
    rows, cols = rng.integers(0, n, 300), rng.integers(0, n, 300)
    mat = tops.build_block_sparse(rows, cols, n, n, block=B,
                                  dtype=torch.float64, padded=True,
                                  device="cpu")
    edges = {(int(r), int(c)) for r, c in zip(rows, cols)}
    compactions = 0
    for step in range(40):
        tail0, e_cap0 = mat.index.tail, mat.index.entry_capacity
        count_builds.clear()
        ins = rng.integers(0, n, (25, 2))
        present = sorted(edges)
        dels = [present[i] for i in rng.choice(len(present), 10,
                                               replace=False)]
        r = np.concatenate([ins[:, 0], [d[0] for d in dels]])
        c = np.concatenate([ins[:, 1], [d[1] for d in dels]])
        v = np.concatenate([np.ones(25), -np.ones(10)])
        edges -= set(dels)
        edges |= {(int(a), int(b)) for a, b in ins}
        mat = tops.apply_delta(mat, r, c, v)
        if count_builds:              # compaction: tail restarts, exact
            compactions += 1
            assert mat.index.tail == int(mat.index.cnt.sum())
            assert (mat.index.tail <= tail0
                    or mat.index.entry_capacity != e_cap0)
        _check_index(mat)
        _same_as_fresh_build(mat)
    assert compactions >= 1


# ---------------------------------------------------------------------------
# (c) a plain reading of the index == the plain versions over the tiles
# ---------------------------------------------------------------------------

def _packed_reading(mat, x, semiring, ids=None):
    """y over the packed index as the kernels compute it: for each listed
    row-block, each row folds its slots' partials in slot order, each
    partial the row's entries in order; accumulation in f64 (the f64
    kernel's order)."""
    B, mt, index = mat.block, mat.max_tiles, mat.index
    xh = x.to(torch.float64).numpy()
    cols_h = mat.tile_cols_h
    idx_h = mat.tile_idx_h.reshape(mat.n_rb, mt)
    blocks = range(mat.n_rb) if ids is None else [i for i in ids if i >= 0]
    y = np.zeros(mat.n_rb * B)
    for rb in blocks:
        acc = np.zeros(B)
        for j in range(mt):
            c = cols_h[rb, j]
            if c < 0:
                continue
            rows, ecols, vals = _tile_entries(index, idx_h[rb, j], B)
            part = np.zeros(B)
            np.add.at(part, rows, vals * xh[c * B + ecols])
            acc = (np.maximum(acc, np.minimum(part, 1.0)) if semiring == "or"
                   else acc + part)
        y[rb * B:(rb + 1) * B] = (acc > 0) if semiring == "or" else acc
    return torch.from_numpy(y)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("semiring", ["sum", "or"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 2e-5)])
def test_packed_reading_equals_plain_versions(dtype, tol, semiring, weighted):
    n, B = 300, 16
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, n, 2500), rng.integers(0, n, 2500)
    vals = _weighted(rng, len(rows)) if weighted else None
    mat = tops.build_block_sparse(rows, cols, n, n, block=B, values=vals,
                                  dtype=DTYPES[dtype], padded=True,
                                  device="cpu")
    # after a delta, so the index was refreshed and slots may be reordered
    mat = tops.apply_delta(mat, rng.integers(0, n, 60),
                           rng.integers(0, n, 60), _weighted(rng, 60))
    x = torch.from_numpy(rng.random(n) if semiring == "sum"
                         else (rng.random(n) < 0.2).astype(np.float64))
    xp = tops._pad_x(mat, x.to(DTYPES[dtype]))
    kw = dict(block=B, max_tiles=mat.max_tiles, semiring=semiring)
    args = (mat.tile_idx, mat.tile_cols, mat.tiles, xp)
    y_plain = bsk.block_spmv_plain(*args, **kw).to(torch.float64)
    torch.testing.assert_close(_packed_reading(mat, xp, semiring), y_plain,
                               rtol=tol, atol=tol)
    # the active list with a −1 in the middle
    ids = np.full(mat.n_rb, -1, np.int32)
    pick = rng.choice(mat.n_rb, 7, replace=False).astype(np.int32)
    ids[:3], ids[4:8] = pick[:3], pick[3:]
    ya = bsk.block_spmv_active_plain(torch.from_numpy(ids), *args,
                                     **kw).to(torch.float64)
    yr = _packed_reading(mat, xp, semiring, ids=ids)
    live = np.zeros(mat.n_rb, bool)
    live[pick] = True
    live = torch.from_numpy(np.repeat(live, B))
    torch.testing.assert_close(yr[live], ya[live], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# (d) the refresh makes no host sync
# ---------------------------------------------------------------------------

_READS = ("cpu", "item", "tolist", "numpy", "nonzero", "__bool__",
          "__int__", "__float__")


def test_refresh_reads_nothing_back(monkeypatch, count_builds):
    """``apply_delta`` — the scatter and the index refresh, on a batch that
    opens tiles and on one that does not — calls none of the tensor methods
    that read device memory on the host, and never rebuilds the index."""
    n, B = 128, 16
    rng = np.random.default_rng(3)
    mat = tops.build_block_sparse(rng.integers(0, n, 400),
                                  rng.integers(0, n, 400), n, n, block=B,
                                  dtype=torch.float64, padded=True,
                                  device="cpu")
    batches = [(rng.integers(0, n, 30), rng.integers(0, n, 30),
                np.ones(30)),
               (np.array([0]), np.array([0]), np.zeros(1))]
    reads = []
    for name in _READS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _name=name, _real=real, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    real_nonzero = torch.nonzero
    monkeypatch.setattr(torch, "nonzero",
                        lambda *a, **k: reads.append("torch.nonzero")
                        or real_nonzero(*a, **k))
    count_builds.clear()
    for r, c, v in batches:
        mat = tops.apply_delta(mat, r, c, v)
    monkeypatch.undo()
    assert reads == [] and count_builds == []
    _same_as_fresh_build(mat)
