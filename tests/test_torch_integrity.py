"""The corruption fault domain of the port (``verify``, the repair ladder,
``inject_corruption``, the fused per-drive check, ``report().integrity``,
``ChaosPlan``) against the JAX package's.

Twins of ``tests/test_integrity.py`` keep its sizes (``rmat(9,
avg_degree=6, seed=11)``, B = 64, f64, ``active_policy="rc"``) and seeds.
Each runs ``repro.api.PageRankSession`` (``engine="pallas"``, its XLA tile
backend) and the port's session (``device="cpu"``, the kernels' plain
versions) side by side and asserts the same failure dicts (``mass_error``
and ``drift`` to 1e-12), the same rungs, equal ``report().integrity``
counters, and post-repair ranks within 1e-12 of the reference's and 1e-9 of
the numpy oracle.  The service-scrubber tests and the chaos soak wait for
ROADMAP A 12; ``test_bucket_retraces_counted_separately`` reads jit-cache
fields the port does not keep (ROADMAP watch list 1).

Port-only tests follow: the packed index (``row``/``col``/``off``/``cnt``
and index-only ``val`` flips, each detected and healed by ``rebuild``), the
slot-table check held to the reference's function, and the torn-update
window of ROADMAP C 8.
"""
import json
import zlib

import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import chaos as jchaos
from repro.core import fault_domain as jfd
from repro.core import integrity as jig
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import grid_road, rmat
from repro_torch.api import (ChaosPlan, CorruptionFault,
                             CorruptionFaultDomain, EngineConfig,
                             IntegrityConfig, PageRankSession)
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core import chaos as tchaos
from repro_torch.core import fault_domain as tfd
from repro_torch.core import integrity as ig
from repro_torch.core import tiering
from repro_torch.core.graph import HostGraph

BS = 64
CPU = "cpu"
FLOAT_FIELDS = ("mass_error", "drift")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return rmat(9, avg_degree=6, seed=11)


def _kw(over):
    base = dict(engine="pallas", block_size=BS, active_policy="rc",
                max_iterations=2000)
    base.update(over)
    return base


def _open(graph, *, auto_repair=False, store=None, integrity=None,
          domains=(None, None), **over):
    """The reference's session and the port's on the same graph and
    config; ``store`` (a directory) makes both durable, side by side, and
    ``domains`` is each package's ``fault_domain=``."""
    icfg = integrity or {"auto_repair": auto_repair}
    js = JSession.from_graph(
        graph, config=JConfig(**_kw(over), fault_domain=domains[0],
                              integrity=jig.IntegrityConfig(**icfg)),
        store_dir=None if store is None else str(store / "j"))
    ts = PageRankSession.from_graph(
        HostGraph(graph.n, graph.edges),
        config=EngineConfig(**_kw(over), fault_domain=domains[1],
                            integrity=IntegrityConfig(**icfg)),
        device=CPU, store_dir=None if store is None else str(store / "t"))
    return js, ts


def _stream(js, ts, hg, n_batches, *, seed0=500):
    """A few accepted batches through both sessions; returns the final
    host graph (the reference's lineage)."""
    cur = hg
    for i in range(n_batches):
        dels, ins = random_batch(cur, 8 / max(cur.m, 1), seed=seed0 + i)
        js.update(dels, ins)
        ts.update(dels, ins)
        cur = cur.apply_batch(dels, ins)
    return cur


def _same_failures(a, b):
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys(), (x, y)
        for k in x:
            if k in FLOAT_FIELDS:
                assert abs(float(x[k]) - float(y[k])) <= 1e-12, (k, x, y)
            else:
                assert x[k] == y[k], (k, x, y)


def _same_report(rj, rt, tol=1e-12):
    _same_failures(rj.failures, rt.failures)
    assert rt.repairs == rj.repairs
    assert (rt.ok, rt.checks_run) == (rj.ok, rj.checks_run)
    for f in FLOAT_FIELDS:
        a, b = getattr(rj, f), getattr(rt, f)
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol, f


def _same_state(js, ts, cur, *, oracle_tol=1e-9):
    """Equal integrity counters; ranks within 1e-12 of the reference's and
    ``oracle_tol`` of the numpy oracle of ``cur``."""
    assert ts.report().integrity == js.report().integrity
    rt, rj = ts.ranks, np.asarray(js.R)
    assert np.abs(rt - rj).max() <= 1e-12
    ref = jpr.numpy_reference(cur.snapshot(block_size=BS), iterations=300)
    assert np.abs(rt[:cur.n] - ref[:cur.n]).max() <= oracle_tol


def _verify_both(js, ts, *, tol=1e-12, **kw):
    rj, rt = js.verify(**kw), ts.verify(**kw)
    _same_report(rj, rt, tol)
    return rt


# ---------------------------------------------------------------------------
# twins of tests/test_integrity.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,rung", [
    ("rank", "frontier"),       # invariant violation → DF re-mark + helping
    ("tile", "rebuild"),        # tile flip (pool and index) → rebuild
    ("slot", "rebuild"),        # slot-table flip → operand rebuild
    ("mirror", "rebuild"),      # mirror flip → operand rebuild
])
def test_detect_and_repair(graph, kind, rung):
    js, ts = _open(graph)
    cur = _stream(js, ts, graph, 2)
    assert _verify_both(js, ts, repair=False).ok
    js.inject_corruption(kind, seed=3)
    ts.inject_corruption(kind, seed=3)
    rep = _verify_both(js, ts, repair=True, deep=True)
    assert rep.failures and rep.ok and rung in rep.repairs, rep
    _same_state(js, ts, cur)
    integ = ts.report().integrity
    assert integ["corruption_detected"] == 1
    assert integ["repairs"][rung] >= 1
    # the state is clean again: a fresh check is a no-op
    assert _verify_both(js, ts, repair=False).ok
    _same_state(js, ts, cur)


@pytest.mark.parametrize("kind", ["scatter_drop", "scatter_dup"])
def test_torn_scatter_detected_by_mirror_digests(graph, kind):
    """A dropped / duplicated operand scatter tears the device mirrors away
    from their host twins; the digests catch it, ``rebuild`` heals it."""
    js, ts = _open(graph)
    cur = _stream(js, ts, graph, 1)
    js.inject_corruption(kind)
    ts.inject_corruption(kind)
    dels, ins = random_batch(cur, 8 / cur.m, seed=901)
    js.update(dels, ins)            # the tear happens inside this update
    ts.update(dels, ins)
    cur = cur.apply_batch(dels, ins)
    rep = _verify_both(js, ts, repair=True, deep=False)
    assert any(f["check"] == "mirror_digest" for f in rep.failures)
    assert rep.ok and "rebuild" in rep.repairs
    _same_state(js, ts, cur)


def test_graph_corruption_restores_from_store(graph, tmp_path):
    """Damage to host truth (the deep graph digest) escalates to the
    checkpoint + WAL ``restore`` rung."""
    js, ts = _open(graph, store=tmp_path, durability="wal",
                   checkpoint_interval=2)
    cur = _stream(js, ts, graph, 3)
    js.inject_corruption("graph", seed=7)
    ts.inject_corruption("graph", seed=7)
    rep = _verify_both(js, ts, repair=True, deep=True)
    assert any(f["check"] == "graph_digest" for f in rep.failures)
    assert rep.ok and rep.repairs == ["restore"]
    _same_state(js, ts, cur)
    assert ts.report().integrity["repairs"]["restore"] == 1
    np.testing.assert_array_equal(ts.hg.edges, cur.edges)
    assert ts.store is not None and ts._batch_index == 3


def test_fused_drive_detects_and_auto_repairs(graph):
    """A deferred ``tile`` flip lands right before a batch; the drive's
    fused invariants flag the wrong fixed point's mass and ``update``
    climbs the ladder itself (``auto_repair=True``)."""
    js, ts = _open(graph, auto_repair=True)
    cur = _stream(js, ts, graph, 1)
    js.inject_corruption("tile", seed=5, defer=True)
    ts.inject_corruption("tile", seed=5, defer=True)
    dels, ins = random_batch(cur, 8 / cur.m, seed=911)
    rj, rt = js.update(dels, ins), ts.update(dels, ins)
    assert (rt.stats.sweeps, rt.stats.edges_processed) == (
        rj.stats.sweeps, rj.stats.edges_processed)
    cur = cur.apply_batch(dels, ins)
    integ = ts.report().integrity
    assert integ["corruption_detected"] >= 1
    assert sum(integ["repairs"].values()) >= 1
    _same_state(js, ts, cur)
    assert _verify_both(js, ts, repair=False).ok


def test_corruption_domain_config_schedules_faults(graph):
    """``fault_domain=CorruptionFaultDomain([...])``: each session consumes
    a clone of the schedule, one fault per update, before the batch."""
    dom = CorruptionFaultDomain([CorruptionFault("mirror", seed=9)])
    js, ts = _open(graph, domains=(jfd.CorruptionFaultDomain(
        [jfd.CorruptionFault("mirror", seed=9)]), dom))
    assert dom.pending == 1 and ts._corruption_faults.pending == 1
    cur = _stream(js, ts, graph, 1)
    assert dom.pending == 1 and ts._corruption_faults.pending == 0
    rep = _verify_both(js, ts, repair=True)
    assert rep.repairs == ["rebuild"]
    _same_state(js, ts, cur)
    with pytest.raises(ValueError, match="does not host"):
        EngineConfig(engine="blocked", fault_domain=dom)


def test_verify_clean_is_cheap_and_counts(graph):
    js, ts = _open(graph)
    before = ts.report().integrity["checks_run"]
    rep = _verify_both(js, ts, repair=False, deep=True)
    assert rep.ok and not rep.failures and not rep.repairs
    assert rep.checks_run > 0
    assert ts.report().integrity["checks_run"] == before + rep.checks_run
    assert ts.report().integrity == js.report().integrity


def test_report_times_each_part_and_rung(graph):
    """``IntegrityReport.split_s`` times each part of the detection pass
    and ``rung_s`` each applied rung alone; the rung's RecoveryRecord
    spans the rung and its re-check, so it is the longer of the two.  The
    tiered parts: ``test_tiered_tile_flip_is_hot_slab_rebuild``."""
    ts, _ = _port_session(graph)
    parts = ["ranks", "digests", "sums", "slot_tables", "graph_digest"]
    rep = ts.verify(repair=False, deep=True)
    assert rep.ok and list(rep.split_s) == parts and not rep.rung_s
    assert all(t >= 0 for t in rep.split_s.values())
    assert sum(rep.split_s.values()) <= rep.wall_time_s
    assert list(ts.verify(repair=False, deep=False).split_s) == [
        p for p in parts if p != "graph_digest"]
    ts.inject_corruption("tile", seed=3)
    rep = ts.verify(repair=True, deep=True)
    assert rep.ok and list(rep.rung_s) == rep.repairs == ["rebuild"]
    assert 0 < rep.rung_s["rebuild"] <= ts._recoveries[-1].wall_time_s
    assert set(rep.to_dict()) == {"ok", "checks_run", "failures", "repairs",
                                  "mass_error", "drift", "wall_time_s"}


@pytest.mark.parametrize("integrity", [False, True])
def test_drift_baseline_is_a_copy_only_with_integrity(graph, integrity):
    """The main path copies the drift baseline only when ``integrity=`` is
    set; without it the baseline is the drive's own output, which nothing
    writes in place, so a later ``verify()`` still finds a ``rank`` flip as
    the reference does."""
    icfg = ({"integrity": jig.IntegrityConfig(auto_repair=False)}
            if integrity else {})
    js = JSession.from_graph(graph, config=JConfig(**_kw({}), **icfg))
    ts = PageRankSession.from_graph(
        HostGraph(graph.n, graph.edges), config=EngineConfig(
            **_kw({}), **({"integrity": IntegrityConfig(auto_repair=False)}
                          if integrity else {})), device=CPU)
    cur = _stream(js, ts, graph, 2)
    assert (ts._r_verified is ts.R) != integrity
    assert torch.equal(ts._r_verified, ts.R)
    js.inject_corruption("rank", seed=3)
    ts.inject_corruption("rank", seed=3)
    # shallow: without integrity= neither package tracks the graph digest
    rep = _verify_both(js, ts, repair=True, deep=False)
    assert "rank_drift" in [f["check"] for f in rep.failures]
    assert rep.ok and rep.repairs == ["frontier"]
    _same_state(js, ts, cur)


def test_integrity_config_roundtrips_through_store(graph, tmp_path):
    icfg = {"mass_tol": 1e-5, "scrub_interval_s": 0.05,
            "auto_repair": False}
    js, ts = _open(graph, store=tmp_path, integrity=icfg,
                   durability="wal", checkpoint_interval=1)
    _stream(js, ts, graph, 2)
    js.save()
    ts.save()
    js.close()
    ts.close()
    jmeta = (tmp_path / "j" / "meta.json").read_bytes()
    assert (tmp_path / "t" / "meta.json").read_bytes() == jmeta
    assert json.loads(jmeta)["config"]["integrity"] == \
        IntegrityConfig(**icfg).to_dict()
    back = PageRankSession.restore(str(tmp_path / "t"), device=CPU)
    got = back.config.integrity
    assert isinstance(got, IntegrityConfig)
    assert got.mass_tol == pytest.approx(1e-5)
    assert got.scrub_interval_s == pytest.approx(0.05)
    assert got.auto_repair is False
    assert back.verify(repair=False).ok
    # the reference restores the port's store to the same config
    jback = JSession.restore(str(tmp_path / "t"))
    assert jback.config.integrity.to_dict() == got.to_dict()
    assert np.abs(np.asarray(jback.R) - back.ranks).max() == 0.0


def test_engine_config_coerces_integrity_dict():
    cfg = EngineConfig(engine="pallas",
                       integrity={"mass_tol": 1e-5, "auto_repair": False})
    assert isinstance(cfg.integrity, IntegrityConfig)
    assert cfg.integrity.mass_tol == pytest.approx(1e-5)
    with pytest.raises((TypeError, ValueError)):
        EngineConfig(engine="pallas", integrity={"no_such_knob": 1})
    with pytest.raises(TypeError):
        EngineConfig(integrity=1e-5)
    for bad in ({"mass_tol": 0}, {"drift_tol": -1},
                {"scrub_interval_s": 0}, {"scrub_chunk_bytes": 8}):
        with pytest.raises(ValueError):
            jig.IntegrityConfig(**bad)
        with pytest.raises(ValueError):
            IntegrityConfig(**bad)


# ---------------------------------------------------------------------------
# chaos plans and the fault-domain data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,steps,streams,require,rate", [
    (17, 4, 2, ("rank", "mirror", "graph", "scatter_drop"), 0.0),
    (0, 6, 3, (), 0.5),
    (123, 5, 2, ("tile", "slot", "slot_dead"), 0.3),
    (9, 3, 1, ("scatter_dup",), 1.0),
    (2024, 8, 4, ("rank", "tile", "slot_stuck"), 0.15),
])
def test_chaos_plan_matches_reference(seed, steps, streams, require, rate):
    kw = dict(seed=seed, steps=steps, streams=streams, require=require,
              rate=rate)
    jp, tp = jchaos.ChaosPlan(**kw), ChaosPlan(**kw)
    assert tp.to_dict() == jp.to_dict()
    assert tp.counts() == jp.counts()
    assert [e.to_dict() for e in tp.corruption_events] == \
        [e.to_dict() for e in jp.corruption_events]
    for step in range(steps):
        assert [e.to_dict() for e in tp.events_at(step)] == \
            [e.to_dict() for e in jp.events_at(step)]
    for je, te in zip(jp.events, tp.events):
        jc, tc = je.corruption(), te.corruption()
        assert (jc is None) == (tc is None)
        if tc is not None:
            assert (tc.kind, tc.index, tc.seed) == (jc.kind, jc.index,
                                                    jc.seed)
        js_, ts_ = je.session_fault(stall_s=0.5), te.session_fault(
            stall_s=0.5)
        assert (js_ is None) == (ts_ is None)
        if ts_ is not None:
            assert (ts_.stream, ts_.kind, ts_.stall_s) == (
                js_.stream, js_.kind, js_.stall_s)
    assert tchaos.CHAOS_KINDS == jchaos.CHAOS_KINDS
    with pytest.raises(ValueError):
        ChaosPlan(seed=1, steps=1, streams=1, require=("rank", "tile"))
    with pytest.raises(ValueError):
        ChaosPlan(seed=1, steps=2, streams=1, require=("nope",))


def test_fault_domain_data_matches_reference():
    assert tfd.CORRUPTION_KINDS == jfd.CORRUPTION_KINDS
    assert ig.REPAIR_RUNGS == jig.REPAIR_RUNGS
    assert ig.INVARIANT_FIELDS == jig.INVARIANT_FIELDS
    # the port's packed-index check is its one addition
    assert ig.INTEGRITY_CHECKS == jig.INTEGRITY_CHECKS + ("packed_index",)
    with pytest.raises(ValueError):
        CorruptionFault("bitrot")
    dom = CorruptionFaultDomain()
    dom.inject("rank", seed=4)
    dom.inject("tile", index=2)
    twin = dom.clone()
    assert dom.pop_pending() == CorruptionFault("rank", seed=4)
    assert (dom.pending, twin.pending) == (1, 2)
    assert dom.pending_faults == [CorruptionFault("tile", index=2)]
    with pytest.raises(ValueError, match="single-device"):
        dom.validate_for(topology="sharded")
    with pytest.raises(ValueError):
        tfd.SessionFault(stream=0, kind="stuck")
    rec = dict(domain="corruption", batch_index=2, wall_time_s=0.5,
               rung="rebuild", check="tile_sums", description="x")
    assert tfd.RecoveryRecord(**rec).to_dict() == \
        jfd.RecoveryRecord(**rec).to_dict()


def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    R = rng.random(300)
    R[[3, 40]] = [-0.5, np.nan]
    R[77] = np.inf
    ref = R.copy()
    ref[5] += 1e-3
    valid = np.arange(300) < 280
    got = ig.invariant_vec(torch.tensor(R), torch.tensor(ref),
                           torch.tensor(valid)).numpy()
    want = np.asarray(jig.invariant_vec(R, ref, valid))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for a in (rng.random(1000), rng.integers(0, 9, 5000).astype(np.int32),
              rng.random((64, 64)) > 0.5, np.zeros(0)):
        for chunk in (64, 4096, 1 << 20):
            assert ig.chunked_crc32(a, chunk_bytes=chunk) == \
                jig.chunked_crc32(a, chunk_bytes=chunk)
            assert ig.chunked_crc32(torch.as_tensor(a), chunk_bytes=chunk) \
                == jig.chunked_crc32(a, chunk_bytes=chunk)
    a = rng.integers(0, 5, 10_000).astype(np.int32)
    b = a.astype(np.int64)
    b[7_000] += 1
    assert ig.compare_digests(torch.tensor(a), b, chunk_bytes=4096) == \
        jig.compare_digests(a, b, chunk_bytes=4096) == [6]
    assert ig.compare_digests(a, b[:-1]) == [-1]
    for dt in (np.float64, np.float32):
        g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(20):
            bit = ig.exponent_bit(dt, g1)
            assert bit == jig.exponent_bit(dt, g2)
            v = np.asarray(g1.random(), dt)
            g2.random()
            assert ig.flipped_float(v, bit) == jig.flipped_float(v, bit)


# ---------------------------------------------------------------------------
# tiered sessions: host truth and the slab scrub
# ---------------------------------------------------------------------------

def _pool_bytes(hg, dtype):
    g0 = HostGraph(hg.n, hg.edges).snapshot(block_size=64, device=CPU)
    src, dst = g0.in_edges_host()
    return int(tiering.HostTilePool.from_edges(
        dst, src, g0.n_pad, g0.n_pad, block=64, dtype=dtype).nbytes)


def _local_stream(n, batches, k=16, seed=11, window=1024):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        base = int(rng.integers(0, max(n - window, 1)))
        ins = base + rng.integers(0, min(window, n), (k, 2))
        out.append((np.zeros((0, 2), np.int64), ins))
    return out


def _tiered_pair(hg, dtype, tau, integrity):
    budget = _pool_bytes(hg, dtype) // 2
    kw = dict(engine="pallas", tau=tau, block_size=64, dtype=dtype.__name__,
              device_budget_bytes=budget)
    js = JSession.from_graph(hg, config=JConfig(integrity=integrity, **kw))
    ts = PageRankSession.from_graph(
        HostGraph(hg.n, hg.edges), config=EngineConfig(integrity=integrity,
                                                       **kw), device=CPU)
    js.warmup()
    ts.warmup()
    cur = hg
    for d, i in _local_stream(hg.n, 2):
        js.update(d, i)
        ts.update(d, i)
        cur = cur.apply_batch(d, i)
    return js, ts, cur


def test_verify_scrubs_host_tier():
    """Twin of tests/test_tiering.py::test_verify_scrubs_host_tier: a
    half-budget f32 session checks clean through verify() — sums of host
    truth, host slot tables and the slab scrub."""
    hg = grid_road(32, seed=7)
    js, ts, _ = _tiered_pair(hg, np.float32, 1e-8, {"mass_tol": 1e-4})
    # f32: XLA's and torch's sums of the 1,024 ranks differ in the last
    # bits (~6e-8 seen), so the report's mass_error is held to 1e-6
    rep = _verify_both(js, ts, tol=1e-6)
    assert rep.ok, rep
    assert rep.checks_run > 0
    assert ts.report().integrity == js.report().integrity


def test_tiered_tile_flip_is_hot_slab_rebuild():
    """The tiered ``tile`` kind damages a resident tile's slab entry on the
    device (host truth stays clean); the slab scrub reports it as
    ``hot_slab`` and the ``rebuild`` rung rebuilds both tiers."""
    hg = grid_road(32, seed=7)
    js, ts, cur = _tiered_pair(hg, np.float64, 1e-10,
                               {"auto_repair": False})
    rep = _verify_both(js, ts, repair=False)
    assert rep.ok and list(rep.split_s) == [
        "ranks", "digests", "sums", "slot_tables", "hot_slab",
        "graph_digest"]
    js.inject_corruption("tile", seed=3)
    ts.inject_corruption("tile", seed=3)
    rep = _verify_both(js, ts, repair=True)
    assert [f["check"] for f in rep.failures] == ["hot_slab"]
    assert rep.ok and rep.repairs == ["rebuild"] == list(rep.rung_s)
    _same_state(js, ts, cur)
    assert ts.hot.scrub() == []
    assert _verify_both(js, ts, repair=False).ok


# ---------------------------------------------------------------------------
# port only: the packed index the kernels read
# ---------------------------------------------------------------------------

def _port_session(graph, **over):
    sess = PageRankSession.from_graph(
        HostGraph(graph.n, graph.edges), config=EngineConfig(
            **_kw(over), integrity=IntegrityConfig(auto_repair=False)),
        device=CPU)
    cur = graph
    for i in range(2):
        dels, ins = random_batch(cur, 8 / max(cur.m, 1), seed=500 + i)
        sess.update(dels, ins)
        cur = cur.apply_batch(dels, ins)
    return sess, cur


def _flip_bit(t: torch.Tensor, pos: int, bit: int) -> None:
    """Flip one bit of element ``pos`` of ``t`` in place."""
    raw = t.view(torch.uint8)
    item = t.element_size()
    raw[pos * item + bit // 8] ^= 1 << (bit % 8)


@pytest.mark.parametrize("field", ["row", "col", "off", "cnt", "val"])
def test_packed_index_flip_detected_and_rebuilt(graph, field):
    """One flipped bit in the index alone — an entry's in-tile row or
    column, a tile's offset or count, or a value with the pool left as it
    was — is detected (``packed_index`` or ``tile_sums``) and healed by
    ``rebuild``; the ranks return to the oracle's."""
    sess, cur = _port_session(graph)
    assert sess.verify(repair=False).ok
    mat = sess.inc.mat
    idx = mat.index
    occ = np.argwhere(mat.tile_cols_h >= 0)
    r, c = occ[len(occ) // 2]
    tid = int(mat.tile_idx_h.reshape(mat.tile_cols_h.shape)[r, c])
    off, cnt = int(idx.off[tid]), int(idx.cnt[tid])
    assert cnt >= 2
    e = off + cnt // 2
    if field in ("row", "col"):
        _flip_bit(getattr(idx, field), e, 0)
    elif field in ("off", "cnt"):
        _flip_bit(getattr(idx, field), tid, 0)
    else:
        _flip_bit(idx.val, e, 53)        # an exponent bit of a 1.0
    pool_before = mat.tiles.clone()
    rep = sess.verify(repair=True)
    checks = {f["check"] for f in rep.failures}
    assert checks & {"packed_index", "tile_sums"}, rep.failures
    assert checks <= {"packed_index", "tile_sums"}, rep.failures
    assert rep.ok and rep.repairs == ["rebuild"]
    assert torch.equal(sess.inc.mat.tiles[:len(pool_before)],
                       pool_before)
    assert sess.verify(repair=False).ok
    ref = jpr.numpy_reference(cur.snapshot(block_size=BS), iterations=300)
    assert np.abs(sess.ranks[:cur.n] - ref[:cur.n]).max() <= 1e-9
    assert sess.report().integrity["repairs"]["rebuild"] == 1


def test_tile_kind_flips_both_copies(graph):
    """The ``tile`` kind flips the same entry of the dense pool and of the
    packed index (the plain versions read the one, the CUDA kernels the
    other), so a re-pack of the tile keeps the damage."""
    sess, _ = _port_session(graph)
    pool, val = sess.inc.mat.tiles.clone(), sess.inc.mat.index.val.clone()
    sess.inject_corruption("tile", seed=3)
    mat = sess.inc.mat
    dp = (mat.tiles != pool).nonzero()
    dv = (mat.index.val != val).nonzero()
    assert len(dp) == 1 and len(dv) == 1
    tid, bi, bj = (int(x) for x in dp[0])
    e = int(dv[0, 0])
    assert (int(mat.index.row[e]), int(mat.index.col[e])) == (bi, bj)
    assert float(mat.index.val[e]) == float(mat.tiles[tid, bi, bj]) < 1.0
    assert int(mat.index.off[tid]) <= e < int(mat.index.off[tid]) + int(
        mat.index.cnt[tid])
    assert [f["check"] for f in sess.verify(repair=False).failures] == [
        "tile_sums"]


def _tables(rng, n_rb, n_cb, mt):
    """Random slot tables and their block adjacency."""
    tc = np.full((n_rb, mt), -1, np.int32)
    ti = np.zeros((n_rb, mt), np.int32)
    bmat = np.zeros((n_rb, n_cb), bool)
    nxt = 0
    for r in range(n_rb):
        k = int(rng.integers(0, mt + 1))
        cols = np.sort(rng.choice(n_cb, k, replace=False))
        tc[r, :k] = cols
        ti[r, :k] = np.arange(nxt, nxt + k)
        bmat[r, cols] = True
        nxt += k
    return tc, ti, bmat, max(nxt, 1)


@pytest.mark.parametrize("damage", ["none", "col_range", "col_dup",
                                    "bmat_mismatch", "tile_idx", "negative",
                                    "bmat_bit", "many"])
def test_slot_table_check_matches_reference(damage):
    """The check without the dense count grid finds the reference's
    failures (the same ``what`` values, the same first 8 row-blocks)."""
    rng = np.random.default_rng(zlib.crc32(damage.encode()))
    tc, ti, bmat, cap = _tables(rng, 40, 30, 6)
    occ = np.argwhere(tc >= 0)
    r, c = occ[len(occ) // 3]
    if damage == "col_range":
        tc[r, c] = 30 + 5
    elif damage == "col_dup":
        r = next(r for r in range(40) if (tc[r] >= 0).sum() >= 2)
        tc[r, 1] = tc[r, 0]
    elif damage == "bmat_mismatch":
        tc[r, c] = (tc[r, c] + 7) % 30
    elif damage == "tile_idx":
        ti[r, c] = cap + 3
    elif damage == "negative":
        tc[r, c] = -7
    elif damage == "bmat_bit":
        bmat[rng.integers(40), rng.integers(30)] ^= True
    elif damage == "many":
        for rr, cc in occ[::3]:
            tc[rr, cc] = (tc[rr, cc] + 11) % 30
        bmat[::5, ::4] ^= True
    want = jig.check_slot_tables(tc, ti.reshape(-1), bmat, cap)
    got = ig.check_slot_tables(torch.tensor(tc), torch.tensor(ti.reshape(-1)),
                               bmat, cap)
    assert got == want
    assert (damage == "none") == (got == [])


def test_torn_update_window_is_detected_and_rebuilt(graph, tmp_path,
                                                    monkeypatch):
    """ROADMAP C 8: the port patches the operand mirrors (and the
    out-degree's host twin) before ``inc.advance``.  A raise right after
    that patch revokes the WAL record and leaves the mirrors a batch ahead
    of the host graph; ``verify`` reports ``mirror_digest`` and ``rebuild``
    returns the session to the pre-batch graph and ranks."""
    sess = PageRankSession.from_graph(
        HostGraph(graph.n, graph.edges), config=EngineConfig(
            **_kw(dict(durability="wal")),
            integrity=IntegrityConfig(auto_repair=False)),
        device=CPU, store_dir=str(tmp_path / "s"))
    dels, ins = random_batch(graph, 8 / graph.m, seed=500)
    sess.update(dels, ins)
    cur = graph.apply_batch(dels, ins)
    store = SessionStore(str(tmp_path / "s"))
    tip, edges0 = store.wal_tip(), sess.hg.edges.copy()

    def _boom(*a, **k):
        raise RuntimeError("torn between the mirror patch and the matrix")
    monkeypatch.setattr(sess.inc, "advance", _boom)
    dels, ins = random_batch(cur, 8 / cur.m, seed=501)
    with pytest.raises(RuntimeError, match="torn"):
        sess.update(dels, ins)
    monkeypatch.undo()
    assert store.wal_tip() == tip            # the record was revoked
    np.testing.assert_array_equal(sess.hg.edges, edges0)
    rep = sess.verify(repair=True)
    assert any(f["check"] == "mirror_digest" for f in rep.failures), \
        rep.failures
    assert rep.ok and rep.repairs == ["rebuild"]
    np.testing.assert_array_equal(sess.hg.edges, cur.edges)
    ref = jpr.numpy_reference(cur.snapshot(block_size=BS), iterations=300)
    assert np.abs(sess.ranks[:cur.n] - ref[:cur.n]).max() <= 1e-9
    # the stream goes on from the pre-batch state
    sess.update(dels, ins)
    cur = cur.apply_batch(dels, ins)
    ref = jpr.numpy_reference(cur.snapshot(block_size=BS), iterations=300)
    assert np.abs(sess.ranks[:cur.n] - ref[:cur.n]).max() <= 1e-9
    assert sess.verify(repair=False).ok
