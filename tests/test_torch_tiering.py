"""Tiered storage of the port (``EngineConfig(device_budget_bytes=...)``,
pull driver) against the JAX package's.

Twins of the A 10a tests of ``tests/test_tiering.py`` keep the reference's
sizes, budgets, f32 setting and tolerances; ``test_memory_audit_components_
sane`` is adapted because the port's slab holds packed entries, not dense
tiles (``tile_pool`` is 0, the real bytes are ``packed_index``).  Unit
parity against the JAX package (``device="cpu"``, the kernels' plain
versions reading the packed slab) covers ``HotSetManager`` under a
scripted admit/invalidate/delta sequence, ``build_block_sparse(to_device=
False)``, ``df_seed_indices`` and the driver's deferred set; a durable
tiered session restores bit for bit at a checkpoint and, past one, as the
reference's restore does.  Whole tiered sessions of both packages on the
same streams are compared in ``tests/test_torch_tiering_parity.py``.
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import distributed as jdist
from repro.core import faults as jflt
from repro.core import pallas_engine as jpe
from repro.core import tiering as jtier
from repro.core.incremental import IncrementalPullMatrix as JInc
from repro.graphs.generators import grid_road
from repro.kernels.block_spmv import ops as jops
from repro_torch.api import EngineConfig as TConfig
from repro_torch.api import PageRankSession as TSession
from repro_torch.api import SweepCapWarning
from repro_torch.core import faults as tflt
from repro_torch.core import pallas_engine as tpe
from repro_torch.core import tiering
from repro_torch.core.distributed import df_seed_indices
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.incremental import IncrementalPullMatrix as TInc
from repro_torch.kernels.block_spmv import ops

CPU = "cpu"
TAU = 1e-8
# the maxdr convergence escape abandons waves whose per-sweep change is
# <= tau, so two runs may differ by ~tau * alpha / (1 - alpha) ≈ 5.7 tau
ABANDON_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _thg(hg):
    return THostGraph(hg.n, hg.edges)


def _pool_bytes(hg, block_size=64, dtype=np.float32):
    g0 = _thg(hg).snapshot(block_size=block_size, device=CPU)
    src, dst = g0.in_edges_host()
    pool = tiering.HostTilePool.from_edges(
        dst, src, g0.n_pad, g0.n_pad, block=block_size, dtype=dtype)
    return int(pool.nbytes)


def _cfg(budget=None, tau=TAU):
    return TConfig(engine="pallas", tau=tau, block_size=64,
                   dtype="float32", device_budget_bytes=budget)


def _local_stream(n, batches, k=16, seed=11, window=1024):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        base = int(rng.integers(0, max(n - window, 1)))
        ins = base + rng.integers(0, min(window, n), (k, 2))
        out.append((np.zeros((0, 2), np.int64), ins))
    return out


def _run_stream(hg, cfg, stream):
    sess = TSession.from_graph(_thg(hg), config=cfg, device=CPU)
    sess.warmup()
    stats = [sess.update(d, i).stats for d, i in stream]
    return sess, stats


# ---------------------------------------------------------------------------
# twins of tests/test_tiering.py: parity + drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_tiered_stream_matches_untiered(frac):
    hg = grid_road(32, seed=7)
    stream = _local_stream(hg.n, 3)
    budget = max(int(_pool_bytes(hg) * frac), 1)
    tiered, st_t = _run_stream(hg, _cfg(budget), stream)
    plain, st_p = _run_stream(hg, _cfg(None), stream)
    assert all(s.converged for s in st_t)
    assert all(s.converged for s in st_p)
    linf = float(np.max(np.abs(tiered.ranks - plain.ranks)))
    assert linf < ABANDON_TOL, linf
    rep = tiered.report()
    assert rep.tiering is not None
    assert rep.retraces_post_warmup == 0
    tiered.close(), plain.close()


def test_tight_budget_drains_without_sweep_cap():
    """A budget holding only a fraction of the pool must still converge
    every batch via the deferred-refill loop — no SweepCapWarning, no
    kernel builds, evictions actually exercised."""
    hg = grid_road(64, seed=7)
    stream = _local_stream(hg.n, 4, window=4096)
    budget = _pool_bytes(hg) // 2
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        sess, stats = _run_stream(hg, _cfg(budget), stream)
    assert all(s.converged for s in stats)
    rep = sess.report()
    t = rep.tiering
    assert t["refill_drives"] > 0          # deferrals happened and drained
    assert t["evictions"] > 0              # budget pressure was real
    assert t["resident_blocks"] * 0 == 0 and t["slab_bytes"] <= budget
    assert rep.retraces_post_warmup == 0
    sess.close()


def test_counters_and_hit_rate_sane():
    hg = grid_road(32, seed=7)
    sess, _ = _run_stream(hg, _cfg(_pool_bytes(hg) // 2),
                          _local_stream(hg.n, 3))
    t = sess.report().tiering
    for key in ("hits", "misses", "evictions", "admitted_tiles",
                "transfer_bytes", "refill_drives", "refill_stalls"):
        assert t[key] >= 0, key
    assert t["hits"] + t["misses"] > 0
    assert 0.0 <= t["hit_rate"] <= 1.0
    assert t["transfer_bytes"] > 0         # admissions actually moved bytes
    assert t["slab_tiles"] * t["slab_bytes"] >= 0
    assert t["pool_bytes"] >= t["slab_bytes"]
    sess.close()


def test_budget_below_floor_raises():
    hg = grid_road(16, seed=0)
    with pytest.raises(ValueError, match="too small to make a single"):
        TSession.from_graph(_thg(hg), config=_cfg(budget=64), device=CPU)


def test_capacity_ladder_shrink_and_eviction():
    """Grow-then-delete stream under a fixed budget: pool growth rewidens
    the slot tables while eviction cycles the slab; results must match the
    untiered run (any stale-block read would diverge) and no kernel may be
    built after warmup."""
    hg = grid_road(32, seed=3)
    n = hg.n
    rng = np.random.default_rng(5)
    grow = [rng.integers(0, n, (24, 2)) for _ in range(3)]
    stream = [(np.zeros((0, 2), np.int64), g) for g in grow]
    stream += [(g, np.zeros((0, 2), np.int64)) for g in reversed(grow)]
    budget = _pool_bytes(hg) // 2
    tiered, st_t = _run_stream(hg, _cfg(budget), stream)
    plain, st_p = _run_stream(hg, _cfg(None), stream)
    assert all(s.converged for s in st_t)
    linf = float(np.max(np.abs(tiered.ranks - plain.ranks)))
    assert linf < ABANDON_TOL, linf
    rep = tiered.report()
    assert rep.retraces_post_warmup == 0
    assert rep.tiering["evictions"] > 0
    # the scrub CRCs every resident tile's packed slab entries against the
    # host pool packed the same way — a stale resident block fails here
    assert tiered.hot.scrub() == []
    tiered.close(), plain.close()


def test_memory_audit_components_sane():
    """Adapted: the port's slab holds packed entries, so the device holds
    no dense tile (``tile_pool`` 0); its real bytes (``packed_index``, also
    the manager's ``device_bytes``) stay within the reference's dense-tile
    charge ``slab_bytes``, and the untiered twin holds more."""
    hg = grid_road(32, seed=7)
    budget = _pool_bytes(hg) // 2
    sess, _ = _run_stream(hg, _cfg(budget), _local_stream(hg.n, 2))
    rep = sess.report()
    db = rep.device_bytes
    for comp in ("ranks", "packed_index", "slot_tables", "operand_mirrors"):
        assert comp in db and db[comp] > 0, comp
    assert db["tile_pool"] == 0
    assert db["packed_index"] <= rep.tiering["slab_bytes"] <= budget
    assert rep.tiering["device_bytes"] == sess.hot.device_bytes() == (
        db["packed_index"] + db["slot_tables"])
    assert rep.bytes_per_vertex == pytest.approx(
        sum(db.values()) / sess.n)
    plain, _ = _run_stream(hg, _cfg(None), _local_stream(hg.n, 2))
    pdb = plain.report().device_bytes
    assert pdb["tile_pool"] > db["packed_index"]
    assert pdb["tile_pool"] + pdb["packed_index"] > db["packed_index"]
    sess.close(), plain.close()


def test_save_restore_budget_independent(tmp_path):
    """Checkpoints serialize host truth: a session saved under one budget
    restores bit-identically under another (or untiered)."""
    hg = grid_road(32, seed=7)
    sess, _ = _run_stream(hg, _cfg(_pool_bytes(hg) // 2),
                          _local_stream(hg.n, 2))
    d = str(tmp_path / "ckpt")
    sess.save(d)
    ref = sess.ranks.copy()
    for cfg in (_cfg(_pool_bytes(hg)), _cfg(None)):
        back = TSession.restore(d, config=cfg, device=CPU)
        np.testing.assert_array_equal(back.ranks, ref)
        dels, ins = _local_stream(hg.n, 1, seed=99)[0]
        assert back.update(dels, ins).stats.converged
        back.close()
    sess.close()


def test_fork_isolated():
    hg = grid_road(32, seed=7)
    sess, _ = _run_stream(hg, _cfg(_pool_bytes(hg) // 2),
                          _local_stream(hg.n, 1))
    child = sess.fork()
    before = child.ranks.copy()
    dels, ins = _local_stream(hg.n, 1, seed=42)[0]
    sess.update(dels, ins)
    np.testing.assert_array_equal(child.ranks, before)
    assert child.update(dels, ins).stats.converged
    # the branches share no slab storage
    assert child.hot._index.val.data_ptr() != sess.hot._index.val.data_ptr()
    child.close(), sess.close()


# ---------------------------------------------------------------------------
# unit parity
# ---------------------------------------------------------------------------

def _pools(hg, dtype=np.float64):
    g0 = hg.snapshot(block_size=64)
    src, dst = g0.in_edges_host()
    jp = jtier.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                       block=64, dtype=dtype)
    tp = tiering.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                         block=64, dtype=dtype)
    return jp, tp


def _assert_managers_equal(jh, th):
    np.testing.assert_array_equal(th.resident, jh.resident)
    np.testing.assert_array_equal(th.last_touch, jh.last_touch)
    np.testing.assert_array_equal(th._ref, jh._ref)
    np.testing.assert_array_equal(th._slot_of_tile, jh._slot_of_tile)
    assert th._free == jh._free
    assert th._rb_slots == jh._rb_slots
    assert th.counters == jh.counters
    if jh._tables_dirty:
        return      # the view is rebuilt by the next admission
    # the view: the same slot tables and rb_res, and resident rows of the
    # packed slab equal to the reference's dense slab
    jv, tv = jh.view(), th.view()
    np.testing.assert_array_equal(tv.tile_cols.numpy(),
                                  np.asarray(jv.tile_cols))
    np.testing.assert_array_equal(tv.tile_idx.numpy(),
                                  np.asarray(jv.tile_idx))
    np.testing.assert_array_equal(th.rb_res.numpy(), np.asarray(jh.rb_res))
    x = np.random.default_rng(1).random(jv.n_cols)
    yj = np.asarray(jops.block_spmv(jv, jnp.asarray(x), backend="xla"))
    yt = ops.block_spmv(tv, torch.from_numpy(x)).numpy()
    rows = np.repeat(th.resident, 64)[:len(yt)]
    np.testing.assert_allclose(yt[rows], yj[rows], rtol=0, atol=1e-12)
    assert th.scrub() == []


def test_hot_set_manager_matches_reference():
    """A scripted admit / invalidate / delta sequence through both
    managers: the resident set, the free list, the tile→slot map, the slot
    assignment and the counters stay array-equal step for step."""
    hg = grid_road(32, seed=7)
    jp, tp = _pools(hg)
    max_rb = int((tp.tile_cols >= 0).sum(axis=1).max())
    budget = (3 * max_rb + 1) * 64 * 64 * 8       # about three row-blocks
    jh = jtier.HotSetManager(jp, budget)
    th = tiering.HotSetManager(tp, budget, device=CPU)
    rng = np.random.default_rng(3)
    steps = [("admit", [0, 1, 2]), ("admit", [5, 6]), ("admit", [1, 9]),
             ("invalidate", [1]), ("admit", [1, 3, 4, 7]),
             ("delta", None), ("admit", [2, 8, 15]), ("invalidate_all", None),
             ("admit", [10, 11])]
    for op, arg in steps:
        if op == "admit":
            assert th.admit(np.asarray(arg)) == jh.admit(np.asarray(arg))
        elif op == "invalidate":
            th.invalidate(np.asarray(arg))
            jh.invalidate(np.asarray(arg))
        elif op == "invalidate_all":
            th.invalidate_all()
            jh.invalidate_all()
        else:
            rows, cols = rng.integers(0, 1024, (2, 40))
            vals = np.ones(40)
            pj = jp.apply_delta(rows, cols, vals)
            pt = tp.apply_delta(rows, cols, vals)
            np.testing.assert_array_equal(pt.touched_rb, pj.touched_rb)
            for h, p in ((jh, pj), (th, pt)):
                h.invalidate(p.touched_rb,
                             structure_changed=(p.tile_cols is not None
                                                or p.n_new > p.n_old))
        _assert_managers_equal(jh, th)
    np.testing.assert_array_equal(tp.mat.tiles, jp.mat.tiles)
    assert th.stats()["evictions"] > 0
    # a fork is independent of its parent
    twin = th.fork(tp.copy())
    twin.admit(np.asarray([12, 13]))
    assert not th.resident[12] and twin.resident[12]


def test_build_block_sparse_host_layout_matches_reference():
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 300, (2, 2000))
    for padded in (False, True):
        j = jops.build_block_sparse(rows, cols, 300, 300, block=64,
                                    dtype=np.float32, padded=padded,
                                    to_device=False)
        t = ops.build_block_sparse(rows, cols, 300, 300, block=64,
                                   dtype=np.float32, padded=padded,
                                   to_device=False)
        assert isinstance(t.tiles, np.ndarray) and t.index is None
        assert t.max_tiles == j.max_tiles
        for f in ("tiles", "tile_cols", "tile_idx"):
            got, want = getattr(t, f), getattr(j, f)
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="no packed index"):
        ops.build_index(t.tiles)
    with pytest.raises(ValueError, match="no packed index"):
        ops.host_block_sparse(300, 300, 64, t.max_tiles, t.tiles,
                              t.tile_cols, t.tile_idx).__class__(
            n_rows=300, n_cols=300, block=64, max_tiles=t.max_tiles,
            tiles=t.tiles, tile_cols=t.tile_cols, tile_idx=t.tile_idx,
            tile_cols_h=t.tile_cols, tile_idx_h=t.tile_idx,
            index=ops.build_index(torch.zeros(1, 64, 64)))


def test_df_seed_indices_matches_reference():
    hg = grid_road(32, seed=7)
    rng = np.random.default_rng(4)
    cur = hg
    for _ in range(3):
        ins = rng.integers(0, hg.n, (20, 2))
        dels = cur.edges[rng.integers(0, cur.m, 6)]
        nxt = cur.apply_batch(dels, ins)
        sources = np.concatenate([dels[:, 0], ins[:, 0], [-1, hg.n]])
        want = jdist.df_seed_indices(cur, nxt, sources)
        got = df_seed_indices(_thg(cur), _thg(nxt), sources)
        np.testing.assert_array_equal(got, want)
        cur = nxt


def test_driver_deferred_set_matches_reference():
    """``_driver(tiered=True)`` on a hand-made residency indicator: seeds
    and expansion candidates in non-resident blocks are deferred, and the
    deferred set, the counters and the ranks equal the reference's."""
    hg = grid_road(24, seed=2)
    gj = hg.snapshot(block_size=32)
    gt = _thg(hg).snapshot(block_size=32, device=CPU)
    jinc = JInc.from_snapshot(gj, dtype=np.float64, padded=True)
    tinc = TInc.from_snapshot(gt, dtype=torch.float64, padded=True)
    n_rb = gj.n_blocks
    rb_res = np.arange(n_rb) % 3 != 1
    rng = np.random.default_rng(8)
    r0 = rng.random(gj.n_pad)
    r0[gj.n:] = 0
    r0 /= r0.sum()
    aff = rng.random(gj.n_pad) < 0.05
    jt = jflt.NO_FAULTS.device_tables(200)
    tt = [torch.as_tensor(a) for a in tflt.NO_FAULTS.device_tables(200)]
    kw = dict(n=gj.n, block_size=32, mode="lf", expand=True,
              active_policy="affected", max_iterations=200)
    Rj, svj, dj = jpe._driver(
        jinc.mat, jnp.asarray(r0), jnp.asarray(aff), gj.vertex_valid,
        gj.out_deg, jnp.asarray(jinc.aux.rb_in), jnp.asarray(jinc.aux.rb_out),
        jnp.asarray(jinc.aux.bmat), jnp.asarray(rb_res),
        jnp.asarray(0.85), jnp.asarray(1e-10), jnp.asarray(1e-13), *jt,
        interpret=True, backend="xla", tiered=True, **kw)
    f = torch.tensor
    Rt, svt, _ = tpe._driver(
        tinc.mat, torch.from_numpy(r0), torch.from_numpy(aff),
        gt.vertex_valid, gt.out_deg, torch.as_tensor(tinc.aux.rb_in),
        torch.as_tensor(tinc.aux.rb_out), torch.as_tensor(tinc.aux.bmat),
        f(0.85, dtype=torch.float64), f(1e-10, dtype=torch.float64),
        f(1e-13, dtype=torch.float64), *tt,
        rb_res=torch.from_numpy(rb_res), tiered=True, **kw)
    assert svt.shape == (7 + n_rb,)
    deferred = svt[7:] != 0
    np.testing.assert_array_equal(deferred, np.asarray(dj))
    assert deferred.any() and not deferred[rb_res].any()
    np.testing.assert_array_equal(svt[:4], np.asarray(svj)[:4])
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() <= 1e-12
    # untiered callers get the 7-entry vector, as before
    _, sv7, _ = tpe._driver(
        tinc.mat, torch.from_numpy(r0), torch.from_numpy(aff),
        gt.vertex_valid, gt.out_deg, torch.as_tensor(tinc.aux.rb_in),
        torch.as_tensor(tinc.aux.rb_out), torch.as_tensor(tinc.aux.bmat),
        f(0.85, dtype=torch.float64), f(1e-10, dtype=torch.float64),
        f(1e-13, dtype=torch.float64), *tt, **kw)
    assert sv7.shape == (7,)


# ---------------------------------------------------------------------------
# durability of a tiered session
# ---------------------------------------------------------------------------

def _durable_kw(hg):
    return dict(engine="pallas", tau=1e-10, block_size=64,
                device_budget_bytes=_pool_bytes(hg, dtype=np.float64) // 2,
                durability="wal", checkpoint_interval=3)


def test_durable_tiered_session_restores_bit_for_bit(tmp_path):
    """A durable tiered session abandoned at a checkpoint restores bit for
    bit: ranks, and a tiering report, with no WAL batch to replay."""
    hg = grid_road(32, seed=7)
    stream = _local_stream(hg.n, 3, seed=21)
    dt = str(tmp_path / "port")
    live = TSession.from_graph(_thg(hg), config=TConfig(**_durable_kw(hg)),
                               device=CPU, store_dir=dt)
    live.warmup()
    for dels, ins in stream:              # batch 3 is checkpoint 3
        assert live.update(dels, ins).converged
    back = TSession.restore(dt, device=CPU)
    assert back.report().replayed_batches == 0
    assert back.report().tiering is not None
    np.testing.assert_array_equal(back.ranks, live.ranks)
    back.close(), live.close()


def test_durable_tiered_wal_replay_matches_reference(tmp_path):
    """Past a checkpoint the WAL replay starts from an empty hot set, so
    the replayed batch converges along another residency path than the
    live session's, within the drain's abandonment bound.  The reference's
    restore does the same: the port's restore equals the reference's to
    ≤ 1e-12, its distance from its live session equals the reference's to
    ≤ 1e-12, and two restores of one store are bit-identical."""
    hg = grid_road(32, seed=7)
    stream = _local_stream(hg.n, 6, seed=21)
    kw = _durable_kw(hg)
    dt, dj = str(tmp_path / "port"), str(tmp_path / "ref")
    live = TSession.from_graph(_thg(hg), config=TConfig(**kw), device=CPU,
                               store_dir=dt)
    jlive = JSession.from_graph(hg, config=JConfig(**kw), store_dir=dj)
    live.warmup(), jlive.warmup()
    for dels, ins in stream[:4]:          # checkpoint 3 + one WAL batch
        live.update(dels, ins), jlive.update(dels, ins)
    back, again = (TSession.restore(dt, device=CPU) for _ in range(2))
    jback = JSession.restore(dj)
    assert back.report().replayed_batches == 1
    assert jback.report().replayed_batches == 1
    np.testing.assert_array_equal(again.ranks, back.ranks)
    assert back.report().tiering == again.report().tiering
    jl, jb = np.asarray(jlive.ranks), np.asarray(jback.ranks)
    assert float(np.abs(back.ranks - jb).max()) <= 1e-12
    assert float(np.abs(live.ranks - jl).max()) <= 1e-12
    gap, jgap = back.ranks - live.ranks, jb - jl
    assert 0 < float(np.abs(jgap).max()) <= 1e-8
    assert float(np.abs(gap - jgap).max()) <= 1e-12
    again.close(), back.close(), jback.close(), jlive.close(), live.close()
