"""The push driver under a device budget (``EngineConfig(driver="push",
device_budget_bytes=N)``) against the JAX package's.

Unit parity (``device="cpu"``, the kernels' plain versions reading the
packed slab): the tiered ``_push_driver`` on a hot slab's view with a
hand-made residency, and ``residual_refresh_blocks`` on random block lists.
Whole sessions: a twin of ``tests/test_push_engine.py::
test_tiered_half_budget_parity_and_counters`` (grid_road(32), half the
pool, 3 batches) through both packages, a tiered push session's save,
restore (untiered and under the budget) and fork, and its
``recompute("nd"|"static")``.

In f64 the counters of ``report().tiering``, every update's ``SweepStats``
and pushed blocks are equal and ranks and residuals agree to ≤ 1e-12.  In
f32 (τ = 1e-10, the reference test's τ) XLA's and torch's sums differ in
the last bit, and τ lies below the granularity of the residual, which
carries the rounding of p (one ulp of max p is 1.16e-10 here): a vertex
whose |r| is one such ulp in one package is 0 in the other, pushes in one
and not in the other, and the edge counts part (by 2 edges in 83,460 at the
first parting drive, the cold solve's 4th).  The structural counters are
always equal, the rest are held to the 1 % of
``tests/test_torch_tiering_parity.py`` and
``test_f32_push_parting_is_a_tau_crossing`` holds the cause, on this
stream and on the push row of ``benchmarks/scale.py --smoke`` (τ = 1e-8,
warm start, local batches), whose counters that file holds to
``F32_PUSH_RTOL``.
"""
import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import pagerank as jpr
from repro.core import push_engine as jpshe
from repro.core import tiering as jtier
from repro.core.delta import random_batch
from repro.graphs.generators import grid_road
from repro_torch.api import EngineConfig as TConfig
from repro_torch.api import PageRankSession as TSession
from repro_torch.api import SweepCapWarning
from repro_torch.core import push_engine as tpshe
from repro_torch.core import tiering
from repro_torch.core.graph import HostGraph as THostGraph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import scale  # noqa: E402

CPU = "cpu"
ALPHA = 0.85
TAU = 1e-10
B = 64
F32_EVICT_RTOL = 0.01            # tests/test_torch_tiering_parity.py
ABANDON_TOL = 1e-6
STRUCT_COUNTERS = ("slab_tiles", "slab_bytes", "budget_bytes", "pool_tiles",
                   "pool_bytes")
STREAM_COUNTERS = ("resident_blocks", "hits", "misses", "evictions",
                   "admitted_tiles", "transfer_bytes", "refill_drives",
                   "refill_stalls")
# stats vector entries that must be equal: sweeps, pushed blocks, candidate
# blocks, edges, converged, stalled (l1 and max|r| are float sums)
EXACT = [0, 1, 2, 3, 6, 7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bound(n):
    return n * TAU * ALPHA / (1.0 - ALPHA)


def _pools(hg, dtype=np.float64):
    g0 = hg.snapshot(block_size=B)
    src, dst = g0.in_edges_host()
    return (jtier.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                          block=B, dtype=dtype),
            tiering.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                            block=B, dtype=dtype))


def _stream(hg, k, *, rate, seed):
    batches, cur = [], hg
    for i in range(k):
        dels, ins = random_batch(cur, rate, seed=seed + i)
        batches.append((dels, ins))
        cur = cur.apply_batch(dels, ins)
    return batches, cur


def _kw(dtype="float64", budget=None, tau=TAU):
    return dict(engine="pallas", block_size=B, driver="push", tau=tau,
                dtype=dtype, device_budget_bytes=budget)


def _open(cls, hg, r0=None, **kw):
    if cls is JSession:
        return JSession.from_graph(hg, config=JConfig(backend="xla", **kw),
                                   r0=r0)
    return TSession.from_graph(THostGraph(hg.n, hg.edges),
                               config=TConfig(**kw), r0=r0, device=CPU)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same(a, b) -> bool:
    """Equal ``SweepStats`` of the two packages (two dataclasses)."""
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def _drift(sess):
    """Device residual against the invariant rebuilt from host truth."""
    host = tpshe.residual_from_host(sess.hg, sess._out_deg_host,
                                    _host(sess.R), ALPHA)
    return float(np.abs(_host(sess._residual) - host).max())


# ---------------------------------------------------------------------------
# the tiered driver and the block-restricted residual rebuild
# ---------------------------------------------------------------------------

def _slab_views(hg, resident_rb):
    """Both packages' hot slabs with the same row-blocks admitted."""
    jp, tp = _pools(hg)
    budget = int(tp.nbytes)
    jh = jtier.HotSetManager(jp, budget)
    th = tiering.HotSetManager(tp, budget, device=CPU)
    jh.admit(resident_rb)
    th.admit(resident_rb)
    return jh, th


def test_push_driver_tiered_equals_jax():
    """``_push_driver(tiered=True)`` on a slab view with a hand-made
    residency: pushes reach resident blocks only, the deferred set, the
    stats vector, p and r equal the reference's."""
    hg = grid_road(24, seed=2)
    g = hg.snapshot(block_size=B)
    n_rb = g.n_blocks
    res = np.nonzero(np.arange(n_rb) % 3 != 1)[0]
    jh, th = _slab_views(hg, res)
    rng = np.random.default_rng(8)
    P0 = rng.random(g.n_pad) / g.n
    P0[g.n:] = 0
    valid = np.array(g.vertex_valid)
    out_deg = np.array(g.out_deg)
    # the exact residual of P0, so the drive runs to the fixed point
    R0 = tpshe.residual_from_host(THostGraph(hg.n, hg.edges), out_deg, P0,
                                  ALPHA)
    bmat = tiering.host_block_adjacency(th.pool.tile_cols, n_rb)
    Pj, Rj, svj, dj = jpshe._push_driver(
        jh.view(), jnp.asarray(P0), jnp.asarray(R0), g.vertex_valid,
        g.out_deg, g.block_out_edges(), jnp.asarray(bmat), jh.rb_res,
        jnp.asarray(ALPHA), jnp.asarray(TAU), n=g.n, block_size=B,
        max_iterations=300, interpret=True, backend="xla", tiered=True)
    Pt, Rt, svt, _ = tpshe._push_driver(
        th.view(), torch.from_numpy(P0), torch.from_numpy(R0),
        torch.from_numpy(valid), torch.from_numpy(out_deg),
        torch.from_numpy(bmat), torch.tensor(ALPHA, dtype=torch.float64),
        torch.tensor(TAU, dtype=torch.float64), n=g.n, block_size=B,
        max_iterations=300, rb_res=th.rb_res, tiered=True)
    L = tpshe.STATS_LEN
    assert svt.shape == (L + n_rb,)
    deferred = svt[L:] != 0
    np.testing.assert_array_equal(deferred, np.asarray(dj))
    assert deferred.any() and not deferred[res].any()
    svj = np.asarray(svj)
    np.testing.assert_array_equal(svt[EXACT], svj[EXACT])
    np.testing.assert_allclose(svt[4:6], svj[4:6], rtol=1e-12, atol=0)
    assert np.abs(Pt.numpy() - np.asarray(Pj)).max() <= 1e-12
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() <= 1e-12


def test_residual_refresh_blocks_equals_jax():
    """The block-restricted rebuild over a slab view, for random block
    lists: equal to the reference's on the listed blocks (≤ 1e-12), equal
    to host truth there, and the input residual everywhere else."""
    hg = grid_road(24, seed=2)
    g = hg.snapshot(block_size=B)
    n_rb = g.n_blocks
    jh, th = _slab_views(hg, np.arange(n_rb))
    rng = np.random.default_rng(4)
    P = rng.random(g.n_pad) / g.n
    P[g.n:] = 0
    Rr = rng.standard_normal(g.n_pad) * 1e-6
    valid = np.array(g.vertex_valid)
    out_deg = np.array(g.out_deg)
    truth = tpshe.residual_from_host(THostGraph(hg.n, hg.edges), out_deg, P,
                                     ALPHA)
    for k in (1, 3, n_rb // 2, n_rb):
        got = np.sort(rng.choice(n_rb, k, replace=False))
        ids = np.full(n_rb, -1, np.int32)
        ids[:k] = rng.permutation(got)
        rj = np.asarray(jpshe.residual_refresh_blocks(
            jh.view(), jnp.asarray(P), jnp.asarray(Rr), g.vertex_valid,
            g.out_deg, jnp.asarray(ALPHA), jnp.asarray(ids),
            jnp.asarray(np.int32(k)), n=g.n, block_size=B, interpret=True,
            backend="xla"))
        rt = tpshe.residual_refresh_blocks(
            th.view(), torch.from_numpy(P), torch.from_numpy(Rr),
            torch.from_numpy(valid), torch.from_numpy(out_deg),
            torch.tensor(ALPHA, dtype=torch.float64), torch.from_numpy(ids),
            torch.tensor([k], dtype=torch.int64), n=g.n,
            block_size=B).numpy()
        rows = np.repeat(np.isin(np.arange(n_rb), got), B)
        assert np.abs(rt - rj).max() <= 1e-12
        assert np.abs(rt[rows] - truth[rows]).max() <= 1e-12
        np.testing.assert_array_equal(rt[~rows], Rr[~rows])


# ---------------------------------------------------------------------------
# whole tiered push sessions of both packages
# ---------------------------------------------------------------------------

def _assert_counters(tc, jc, dtype):
    for k in STRUCT_COUNTERS:
        assert tc[k] == jc[k], k
    for k in STREAM_COUNTERS:
        if dtype == "float64":
            assert tc[k] == jc[k], k
        else:
            assert tc[k] == pytest.approx(jc[k], rel=F32_EVICT_RTOL), k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tiered_half_budget_parity_and_counters(dtype):
    """Twin of the reference test, on the port, then against the JAX
    tiered push session on the same stream: pushes to non-resident rows
    defer, the refill loop drains every batch, the final state agrees with
    the untiered push session and the oracle, the counters show in
    report(), and the residual equals host truth after every batch."""
    hg = grid_road(32, seed=7)
    budget = int(_pools(hg, np.dtype(dtype))[1].nbytes) // 2
    batches, cur = _stream(hg, 3, rate=4e-3, seed=41)
    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        tiered = _open(TSession, hg, **_kw(dtype, budget))
        plain = _open(TSession, hg, **_kw(dtype))
        ref = _open(JSession, hg, **_kw(dtype, budget))
        for s in (tiered, plain, ref):
            s.warmup()
        for dels, ins in batches:
            rt, rj = tiered.update(dels, ins), ref.update(dels, ins)
            assert rt.converged and rj.converged
            assert plain.update(dels, ins).converged
            rows.append((rt, rj))
            if dtype == "float64":
                assert _drift(tiered) < 1e-12
    f64 = dtype == "float64"
    linf = float(np.abs(tiered.ranks - plain.ranks).max())
    assert linf < (2 * _bound(hg.n) if f64 else ABANDON_TOL), linf
    oracle = jpr.numpy_reference(cur.snapshot(block_size=B), iterations=300)
    err = float(np.abs(tiered.ranks[:cur.n] - oracle[:cur.n]).max())
    assert err < (_bound(cur.n) if f64 else ABANDON_TOL), err

    rep = tiered.report()
    t = rep.tiering
    assert t["misses"] > 0 and t["refill_drives"] > 0
    assert t["slab_bytes"] <= budget
    assert rep.retraces_post_warmup == 0
    assert rep.device_bytes["tile_pool"] <= budget
    # against the reference's session
    _assert_counters(t, ref.report().tiering, dtype)
    for rt, rj in rows:
        if dtype == "float64":
            assert _same(rt.stats, rj.stats)
            assert rt.pushed_blocks == rj.pushed_blocks
        else:
            for c in ("sweeps", "blocks_processed", "edges_processed"):
                assert getattr(rt.stats, c) == pytest.approx(
                    getattr(rj.stats, c), rel=F32_EVICT_RTOL), c
    mutual = float(np.abs(tiered.ranks - np.asarray(ref.ranks)).max())
    assert mutual <= (1e-12 if dtype == "float64" else ABANDON_TOL), mutual
    assert tiered.hot.scrub() == []
    for s in (tiered, plain, ref):
        s.close()


class _Stop(Exception):
    pass


def _witness_case(name):
    """(graph, τ, budget, batches, warm start) of one f32 push stream: the
    reference test's random batches from a cold solve, or the push row of
    ``benchmarks/scale.py --smoke`` (grid_road of the first ladder row,
    budget 0.5, its warm start and local insertion batches), whose f32
    counters ``tests/test_torch_tiering_parity.py`` holds to
    ``F32_PUSH_RTOL``."""
    if name == "random":
        hg = grid_road(32, seed=7)
        return (hg, TAU, int(_pools(hg, np.float32)[1].nbytes) // 2,
                _stream(hg, 3, rate=4e-3, seed=41)[0], None)
    side, tau, n_batches, batch_edges = scale.SMOKE_LADDER[0]
    hg = grid_road(side, seed=7)
    rng = np.random.default_rng(11)
    batches = [(np.zeros((0, 2), np.int64),
                scale._local_batch(rng, hg.n, batch_edges))
               for _ in range(n_batches)]
    return (hg, tau, max(int(_pools(hg, np.float32)[1].nbytes * 0.5), 1),
            batches, scale._reference_ranks(hg).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "smoke_push"])
def test_f32_push_parting_is_a_tau_crossing(monkeypatch, case):
    """Where the f32 tiered push sessions part, the cause is a vertex's
    |r| on the other side of τ by the residual's granularity, not the
    tiering logic: at the first drive whose sweeps, edges, pushed blocks or
    deferral set differ, both drives start from p within 4 ulp and r within
    2 ulp of max p of each other, and stepping the drive sweep by sweep
    from each start, the first sweep whose pushed vertex sets (|r| > τ)
    differ differs only at vertices with ||r| − τ| ≤ 2 ulp of max p."""
    hg, tau_, budget, batches, r0 = _witness_case(case)
    logs = {JSession: [], TSession: []}
    probe = {}

    def hook(cls):
        orig = cls._drive_push

        def drive(self, P0):
            k = len(logs[cls])
            if probe.get("at") == k:
                probe[cls] = (_host(P0).copy(), _host(self._residual).copy())
                if cls is TSession:
                    probe["ops"] = (self.inc.mat, self.valid, self._out_deg,
                                    self._bmat, self._alpha, self._tau,
                                    self.hot.rb_res)
                raise _Stop
            out = orig(self, P0)
            logs[cls].append((out[1].sweeps, out[1].edges_processed,
                              out[2]["pushed_blocks"],
                              self._deferred_rb.tobytes()))
            return out
        monkeypatch.setattr(cls, "_drive_push", drive)

    def run(cls):
        sess = _open(cls, hg, r0=r0, **_kw("float32", budget, tau_))
        sess.warmup()
        for dels, ins in batches:
            sess.update(dels, ins)

    for cls in logs:
        hook(cls)
        run(cls)
    k = next(i for i, (a, b) in enumerate(zip(*logs.values())) if a != b)
    sweeps = max(log[k][0] for log in logs.values())
    probe["at"] = k
    for cls in logs:
        logs[cls].clear()
        with pytest.raises(_Stop):
            run(cls)
    (Pj, Rj), (Pt, Rt) = probe[JSession], probe[TSession]
    ulp = float(np.spacing(np.float32(np.abs(Pj).max())))
    assert float(np.abs(Pj - Pt).max()) <= 4 * ulp
    assert float(np.abs(Rj - Rt).max()) <= 2 * ulp
    mat, valid, out_deg, bmat, alpha, tau, rb_res = probe["ops"]

    def residual_after(P0, R0, m):
        if m == 0:
            return torch.from_numpy(R0)
        return tpshe._push_driver(
            mat, torch.from_numpy(P0), torch.from_numpy(R0), valid, out_deg,
            bmat, alpha, tau, n=hg.n, block_size=B, max_iterations=m,
            rb_res=rb_res, tiered=True)[1]

    for m in range(sweeps + 1):
        a, b = residual_after(Pj, Rj, m), residual_after(Pt, Rt, m)
        part = (a.abs() > tau_) != (b.abs() > tau_)
        if part.any():
            break
    assert part.any()
    for r in (a[part], b[part]):
        assert float(((r.abs() - tau_).abs()).max()) <= 2 * ulp


def test_tiered_push_save_restore_fork(tmp_path):
    """A tiered push session's save, restored untiered and under the
    budget (the residual rebuilt from host truth), and a fork, through both
    packages: ranks ≤ 1e-12 and the counters of the next update equal."""
    hg = grid_road(32, seed=7)
    budget = int(_pools(hg)[1].nbytes) // 2
    batches, _ = _stream(hg, 3, rate=4e-3, seed=61)
    sess = {}
    for cls in (JSession, TSession):
        s = _open(cls, hg, **_kw(budget=budget))
        for dels, ins in batches[:2]:
            assert s.update(dels, ins).converged
        s.save(str(tmp_path / cls.__module__.split(".")[0]))
        sess[cls] = s
    assert float(np.abs(sess[TSession].ranks
                        - np.asarray(sess[JSession].ranks)).max()) <= 1e-12
    dels, ins = batches[2]
    for b in (None, budget):
        cfg = _kw(budget=b)
        jr = JSession.restore(str(tmp_path / "repro"),
                              config=JConfig(backend="xla", **cfg))
        tr = TSession.restore(str(tmp_path / "repro_torch"),
                              config=TConfig(**cfg), device=CPU)
        np.testing.assert_array_equal(tr.ranks, sess[TSession].ranks)
        assert _drift(tr) < 1e-12
        a, b_ = jr.update(dels, ins), tr.update(dels, ins)
        assert a.converged and b_.converged
        assert _same(a.stats, b_.stats)
        assert a.pushed_blocks == b_.pushed_blocks
        assert float(np.abs(tr.ranks - np.asarray(jr.ranks)).max()) <= 1e-12
        if b is not None:
            tc, jc = tr.report().tiering, jr.report().tiering
            assert {k: tc[k] for k in jc} == jc
        jr.close(), tr.close()
    forks = {cls: s.fork() for cls, s in sess.items()}
    before = sess[TSession].ranks.copy()
    res = {cls: f.update(dels, ins) for cls, f in forks.items()}
    assert _same(res[TSession].stats, res[JSession].stats)
    np.testing.assert_array_equal(sess[TSession].ranks, before)
    tf, jf = forks[TSession], forks[JSession]
    assert float(np.abs(tf.ranks - np.asarray(jf.ranks)).max()) <= 1e-12
    tc, jc = tf.report().tiering, jf.report().tiering
    assert {k: tc[k] for k in jc} == jc
    assert _drift(tf) < 1e-12
    for s in (*sess.values(), *forks.values()):
        s.close()


@pytest.mark.parametrize("variant", ["nd", "static"])
def test_tiered_push_recompute_matches_reference(variant):
    """``recompute("nd"|"static")`` on a half-budget push session (every
    block wanted; ``nd`` rebuilds the residual from host truth, ``static``
    restarts cold) through both packages: stats and the tiering counters
    equal, ranks ≤ 1e-12, the residual equal to host truth."""
    hg = grid_road(24, seed=3)
    budget = int(_pools(hg)[1].nbytes) // 2
    (dels, ins), = _stream(hg, 1, rate=4e-3, seed=71)[0]
    res = {}
    for cls in (JSession, TSession):
        s = _open(cls, hg, **_kw(budget=budget))
        assert s.update(dels, ins).converged
        res[cls] = (s, s.recompute(variant))
    (js, jr), (ts, tr) = res[JSession], res[TSession]
    assert tr.converged and _same(tr.stats, jr.stats)
    tc, jc = ts.report().tiering, js.report().tiering
    assert {k: tc[k] for k in jc} == jc
    assert float(np.abs(ts.ranks - np.asarray(js.ranks)).max()) <= 1e-12
    assert _drift(ts) < 1e-12
    js.close(), ts.close()
