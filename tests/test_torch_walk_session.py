"""The port's walk sessions and personalized serving against the JAX
package's: twins of ``tests/test_walk_engine.py``'s session, durable and
service tests, each run on both packages with the same graphs and batches.

Walk buffers, ranks, ``ppr_query`` values and ids, the walk fields of
``StreamBatchResult`` and the work counters are equal bit for bit, after
updates, a fork, a ``recompute``, a WAL restore and through the service's
degraded reads.  Port-only checks follow: the read view's walk clone, the
footprint's ``walk_buffers`` against the reference's, and the integrity
calls a walk session refuses.
"""
import numpy as np
import pytest
import torch

from repro.api import CapabilityError as JCapabilityError
from repro.api import EngineConfig as JConfig
from repro.api import PageRankService as JService
from repro.api import PageRankSession as JSession
from repro.core.delta import random_batch
from repro.core.graph import HostGraph as JHostGraph
from repro.core.walk_engine import WalkState as JWalkState
from repro_torch.api import (CapabilityError, EngineConfig, PageRankService,
                             PageRankSession, ServingConfig)
from repro_torch.core.graph import HostGraph
from repro_torch.core.pagerank import numpy_reference
from repro_torch.core.walk_engine import WalkState

CPU = "cpu"
NONE = np.zeros((0, 2), np.int64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(n=96, m=420, seed=0) -> np.ndarray:
    """The reference test's ``_graph``: random edges, deduplicated, no
    self-loops."""
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], 1)
    e = JHostGraph(n, e).edges
    return e[e[:, 0] != e[:, 1]]


def _pair(n=96, m=420, seed=0):
    e = _edges(n, m, seed)
    return JHostGraph(n, e), HostGraph(n, e)


def _sessions(jh, th, store=None, **kw):
    js = JSession.from_graph(jh, config=JConfig(**kw),
                             store_dir=None if store is None
                             else str(store / "j"))
    ts = PageRankSession.from_graph(th, config=EngineConfig(**kw),
                                    device=CPU,
                                    store_dir=None if store is None
                                    else str(store / "t"))
    return js, ts


def _same_walks(js, ts) -> None:
    for name in ("walks", "counts", "adj", "deg"):
        assert np.array_equal(np.asarray(getattr(js.walks, name)),
                              getattr(ts.walks, name).numpy()), name
    assert np.array_equal(np.asarray(js.R), ts.R.numpy())


def _same_result(a, b) -> None:
    for f in ("regenerated_walks", "touched_walks", "total_walks",
              "batch_edges"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("sweeps", "iterations", "edges_processed", "converged"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f
    assert np.array_equal(np.asarray(a.ranks), b.ranks.numpy())


def _same_ppr(js, ts, seeds, k) -> None:
    jv, ji = js.ppr_query(seeds, k)
    tv, ti = ts.ppr_query(seeds, k)
    assert np.array_equal(jv, tv) and np.array_equal(ji, ti), (ji, ti)


def _same_error(jcall, tcall, exc, jexc, match) -> None:
    with pytest.raises(jexc, match=match) as jerr:
        jcall()
    with pytest.raises(exc, match=match) as terr:
        tcall()
    assert str(jerr.value) == str(terr.value)


# ---------------------------------------------------------------------------
# session walk mode (module-scoped pair, as the reference's fixture)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def walk_sessions():
    jh, th = _pair(seed=21)
    kw = dict(engine="walk", walks_per_vertex=8, walk_length=24,
              walk_seed=2)
    js, ts = _sessions(jh, th, **kw)
    yield jh, js, ts
    js.close()
    ts.close()


def test_session_update_localized_and_retrace_free(walk_sessions):
    hg, js, ts = walk_sessions
    js.warmup()
    ts.warmup()
    cur = hg
    for j in range(3):
        dels, ins = random_batch(cur, 0.05, seed=60 + j)
        jres, res = js.update(dels, ins), ts.update(dels, ins)
        cur = cur.apply_batch(dels, ins)
        assert res.stats.converged
        assert 0 < res.regenerated_walks <= res.touched_walks
        assert res.regenerated_walks < res.total_walks
        assert res.host_syncs == 3
        _same_result(jres, res)
    rep = ts.report()
    assert rep.engine == "walk"
    assert rep.retraces_post_warmup == 0
    assert rep.n_updates >= 3
    assert rep.total_edges_processed == js.report().total_edges_processed
    fresh = WalkState(HostGraph(cur.n, cur.edges), R=8, L=24, seed=2,
                      device=CPU)
    assert torch.equal(ts.walks.walks, fresh.walks)
    _same_walks(js, ts)


def test_session_ppr_query_validation(walk_sessions):
    hg, js, ts = walk_sessions
    vals, idx = ts.ppr_query([0, 1], 5)
    assert len(vals) == len(idx) == 5
    assert (np.diff(vals) <= 0).all()
    for seeds, k in (([0, 1], 5), ([7], 96), ([3, 3, 50], 12),
                     (np.array([90]), 200)):
        _same_ppr(js, ts, seeds, k)
    for seeds, k, match in (([], 5, "at least one seed"),
                            ([ts.n + 2], 5, "out of range"),
                            ([0], 2.5, "k must be an integer"),
                            ([0], 0, "must be >= 1"),
                            ([0.5], 3, "integers")):
        _same_error(lambda: js.ppr_query(seeds, k),
                    lambda: ts.ppr_query(seeds, k), ValueError, ValueError,
                    match)


def test_session_fork_diverges_independently(walk_sessions):
    hg, js, ts = walk_sessions
    jtwin, twin = js.fork(), ts.fork()
    before = ts.walks.walks.clone()
    jres = jtwin.update(NONE, np.array([[0, 5]]))
    res = twin.update(NONE, np.array([[0, 5]]))
    _same_result(jres, res)
    _same_walks(jtwin, twin)
    assert torch.equal(ts.walks.walks, before)
    assert not torch.equal(twin.walks.walks, before)
    twin.close()
    jtwin.close()
    assert not ts.closed
    _same_walks(js, ts)


def test_session_recompute_semantics(walk_sessions):
    hg, js, ts = walk_sessions
    jres, res = js.recompute("static"), ts.recompute("static")
    assert res.stats.converged
    assert res.stats.edges_processed == jres.stats.edges_processed
    assert np.array_equal(np.asarray(jres.ranks), res.ranks.numpy())
    _same_walks(js, ts)
    for variant in ("dt", "df"):
        _same_error(lambda: js.recompute(variant),
                    lambda: ts.recompute(variant), ValueError, ValueError,
                    "marking")


def test_ppr_query_on_sweep_engine_raises_capability_error():
    jh, th = _pair()
    js, ts = _sessions(jh, th, engine="blocked")
    with js, ts:
        _same_error(lambda: js.ppr_query([0, 1], 5),
                    lambda: ts.ppr_query([0, 1], 5), CapabilityError,
                    JCapabilityError, "ppr_query")


def test_walk_engine_snapshot_run_via_registry():
    """``from_snapshot`` without ``hg=`` recovers the host edges without the
    snapshot's self-loops; estimates and reads equal the reference's."""
    jh, th = _pair(n=48, m=180, seed=8)
    kw = dict(engine="walk", walks_per_vertex=64, walk_length=32)
    js = JSession.from_snapshot(jh.snapshot(block_size=64),
                                config=JConfig(**kw))
    g = th.snapshot(block_size=64, device=CPU)
    ts = PageRankSession.from_snapshot(g, config=EngineConfig(**kw))
    ref = numpy_reference(g, iterations=300)[:g.n]
    assert float(np.abs(ts.ranks[:g.n] - ref).sum()) < 0.5
    assert np.array_equal(js.ranks, ts.ranks)
    assert np.array_equal(ts.hg.edges, th.edges)
    _same_ppr(js, ts, [0], 3)
    js.close()
    ts.close()


def test_walk_session_wal_restore_bit_identical(tmp_path):
    """Process-domain durability: checkpoint + WAL replay reproduce the
    walk buffers bit for bit, in each package; a further update after the
    restore gives equal walk fields."""
    jh, th = _pair(n=50, m=220, seed=40)
    kw = dict(engine="walk", walks_per_vertex=6, walk_length=20,
              walk_seed=4, durability="wal")
    js, ts = _sessions(jh, th, store=tmp_path, **kw)
    for j in range(3):
        batch = (NONE, np.array([[j, (j * 7 + 3) % 50]]))
        _same_result(js.update(*batch), ts.update(*batch))
    walks_live = ts.walks.walks.clone()
    ranks_live = ts.ranks.copy()
    js.close()
    ts.close()
    jr = JSession.restore(str(tmp_path / "j"))
    restored = PageRankSession.restore(str(tmp_path / "t"), device=CPU)
    try:
        assert torch.equal(restored.walks.walks, walks_live)
        assert np.array_equal(restored.ranks, ranks_live)
        _same_walks(jr, restored)
        assert restored.report().replayed_batches == \
            jr.report().replayed_batches
        vals, idx = restored.ppr_query([0, 1], 4)
        assert len(vals) == 4
        _same_ppr(jr, restored, [0, 1], 4)
        batch = (np.array([[0, 3]]), np.array([[5, 6]]))
        _same_result(jr.update(*batch), restored.update(*batch))
        _same_walks(jr, restored)
    finally:
        restored.close()
        jr.close()


# ---------------------------------------------------------------------------
# service: per-user personalized serving
# ---------------------------------------------------------------------------

def test_service_serves_personalized_rankings():
    e = [_edges(seed=31), _edges(seed=32)]
    kw = dict(engine="walk", walks_per_vertex=8, walk_length=24)
    jsvc = JService([JHostGraph(96, x) for x in e], config=JConfig(**kw))
    svc = PageRankService([HostGraph(96, x) for x in e],
                          config=EngineConfig(**kw), device=CPU)
    try:
        def both(call):
            a, b = call(jsvc), call(svc)
            assert np.array_equal(a.values, b.values)
            assert np.array_equal(a.vertices, b.vertices)
            assert (a.degraded, a.lag_updates) == (b.degraded,
                                                   b.lag_updates)
            return b

        r = both(lambda s: s.ppr_query(0, [3, 4], 4))
        assert r.degraded             # snapshot (degraded-mode) read
        assert len(r.values) == 4 and len(r.vertices) == 4
        # updates drain while personalized reads keep serving
        for s in (jsvc, svc):
            s.submit(0, NONE, np.array([[0, 9]]))
            while s.step():
                pass
        r2 = both(lambda s: s.ppr_query(0, [3, 4], 4))
        assert r2.lag_updates == 0    # snapshot refreshed to committed
        r3 = both(lambda s: s.ppr_query(1, [7], 2))
        assert len(r3.values) == 2
        both(lambda s: s.top_k(1, 5))
        rep = svc.report()
        assert rep["queries"]["served"] >= 3
        assert rep["queries"]["served"] == jsvc.report()["queries"]["served"]
    finally:
        svc.stop()
        jsvc.stop()


def test_service_ppr_query_needs_the_ppr_capability():
    jh, th = _pair(seed=33)
    jsvc = JService([jh], config=JConfig(engine="blocked"))
    svc = PageRankService([th], config=EngineConfig(engine="blocked"),
                          device=CPU)
    try:
        _same_error(lambda: jsvc.ppr_query(0, [0], 3),
                    lambda: svc.ppr_query(0, [0], 3), CapabilityError,
                    JCapabilityError, "ppr_query")
    finally:
        svc.stop()
        jsvc.stop()


# ---------------------------------------------------------------------------
# port-only
# ---------------------------------------------------------------------------

def test_read_view_holds_its_own_walks():
    """A walk session's read view answers ``ppr_query`` as the session did
    at the view's batch index, from its own clone of the walk buffer."""
    jh, th = _pair(seed=34)
    sess = PageRankSession.from_graph(
        th, device=CPU, config=EngineConfig(engine="walk",
                                            walks_per_vertex=4,
                                            walk_length=16))
    view = sess._read_view()
    assert view.walks.data_ptr() != sess.walks.walks.data_ptr()
    assert view.nbytes == (sess.R.nbytes + sess.valid.nbytes
                           + sess.walks.walks.nbytes)
    before = sess.ppr_query([2, 9], 6)
    sess.update(NONE, np.array([[2, 40], [9, 41]]))
    after = sess.ppr_query([2, 9], 6)
    got = view.ppr_query([2, 9], 6)
    assert np.array_equal(got[0], before[0])
    assert np.array_equal(got[1], before[1])
    assert not np.array_equal(after[0], before[0])
    with pytest.raises(ValueError, match="at least one seed"):
        view.ppr_query([], 3)
    sess.close()
    pallas = PageRankSession.from_graph(th, device=CPU)
    with pytest.raises(CapabilityError, match="'ppr' capability"):
        pallas._read_view().ppr_query([0], 3)
    pallas.close()


def test_walk_buffers_footprint_against_reference():
    """The port counts the store's four device tensors; the reference also
    counts its 8-byte PRNG key and 4-byte f32 alpha."""
    jh, th = _pair(seed=35)
    kw = dict(engine="walk", walks_per_vertex=3, walk_length=10)
    js, ts = _sessions(jh, th, **kw)
    jb, tb = js.report().device_bytes, ts.report().device_bytes
    assert tb["ranks"] == jb["ranks"]
    assert tb["walk_buffers"] == jb["walk_buffers"] - 12
    assert tb["walk_buffers"] == ts.walks.nbytes
    assert isinstance(js.walks, JWalkState)
    js.close()
    ts.close()
    assert ts.report().device_bytes is None


def test_walk_session_refuses_integrity_calls():
    _, th = _pair(seed=36)
    sess = PageRankSession.from_graph(
        th, device=CPU, config=EngineConfig(engine="walk",
                                            walks_per_vertex=2,
                                            walk_length=4))
    for call in (sess.verify, lambda: sess.inject_corruption("rank")):
        with pytest.raises(ValueError, match="walk engine hosts no"):
            call()
    sess.close()


def test_walk_service_slot_survives_serving_config():
    """A walk slot under a coalescing service with no degraded reads serves
    ``ppr_query`` live from the session."""
    _, th = _pair(seed=37)
    svc = PageRankService([th], device=CPU,
                          config=EngineConfig(engine="walk",
                                              walks_per_vertex=4,
                                              walk_length=12),
                          serving=ServingConfig(degraded_reads=False))
    try:
        svc.submit(0, NONE, np.array([[1, 2]]))
        svc.submit(0, NONE, np.array([[3, 4]]))
        while svc.step():
            pass
        r = svc.ppr_query(0, [1, 3], 5)
        assert not r.degraded
        v, i = svc.sessions[0].ppr_query([1, 3], 5)
        assert np.array_equal(r.values, v) and np.array_equal(r.vertices, i)
    finally:
        svc.stop()
