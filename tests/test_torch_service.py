"""The port's serving surface (``PageRankService``, ``ServingConfig``,
``AdmissionRejected``, ``ReadResult``, the ranks-only read view, the
watchdog's failover) against the JAX package's.

Twins of ``tests/test_service_overload.py`` (all of it), of
``tests/test_api_session.py::TestService`` and
``::test_close_unregisters_from_service``, and of
``tests/test_fault_domains.py::test_service_failover_respawns_from_store``
keep the reference's graphs (each package's own generator, same seeds),
batches and serving policies.  In synchronous ``step()`` mode both services
take the same submits and must agree on shed reasons and
``AdmissionRejected.reason`` dicts, on ``requests_done``,
``requests_shed``, ``retries`` and ``failovers[*].replayed_batches``, on
each session's sweeps and edges, and on ranks to 1e-12 (f64).  The tests
whose outcome depends on timing (a late completion, a stale view, a stuck
slot under background load) assert what the reference test asserts, on the
port alone (``device="cpu"``: the kernels' plain versions).

Port-only tests follow: ``ServingConfig``'s errors equal the reference's,
the read view owns its storage and holds only ``R`` and ``valid``, a CPU
slot fails over onto the CPU, the repair ladder's ``restore`` rung keeps
the service's backref, and a walk slot serves ``ppr_query``.
"""
import time
import warnings

import numpy as np
import pytest
import torch

from repro.api import AdmissionRejected as JRejected
from repro.api import EngineConfig as JConfig
from repro.api import PageRankService as JService
from repro.api import PageRankSession as JSession
from repro.api import ServingConfig as JServing
from repro.api import SweepCapWarning as JSweepCapWarning
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import kmer_chains as jkmer_chains
from repro.graphs.generators import rmat as jrmat
from repro_torch.api import (AdmissionRejected, EngineConfig,
                             IntegrityConfig, PageRankService,
                             PageRankSession, ReadResult, ServingConfig,
                             SweepCapWarning)
from repro_torch.api.session import ReadView
from repro_torch.core.stream import run_stream
from repro_torch.graphs.generators import kmer_chains, rmat

BLOCK = 64
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(**kw):
    return dict(engine="pallas", block_size=BLOCK, **kw)


def _graphs(gen_j, gen_t, *args, **kw):
    """The reference's graph and the port's, each from its own package's
    generator with the same arguments; they must hold the same edges."""
    jg, tg = gen_j(*args, **kw), gen_t(*args, **kw)
    assert tg.n == jg.n and np.array_equal(tg.edges, jg.edges)
    return jg, tg


def _batches(hg, k, seed0=0):
    """k sequential random batches + the graph after each prefix."""
    out, cur = [], hg
    for i in range(k):
        d, ins = random_batch(cur, 1e-2, seed=seed0 + i)
        out.append((d, ins))
        cur = cur.apply_batch(d, ins)
    return out, cur


def _services(jgraphs, tgraphs, *, serving=None, **kw):
    """The reference's service and the port's over the same graphs (or
    sessions) and policy; ``kw`` are ``EngineConfig`` fields and
    ``warmup``."""
    warm = kw.pop("warmup", True)
    sv = dict(serving or {})
    js = JService(jgraphs, config=JConfig(**_kw(**kw)), warmup=warm,
                  serving=JServing(**sv))
    ts = PageRankService(tgraphs, config=EngineConfig(**_kw(**kw)),
                         warmup=warm, serving=ServingConfig(**sv),
                         device=CPU)
    return js, ts


def _reason(r: dict) -> dict:
    """A shed reason without its message when the message holds a time."""
    if r["code"] == "deadline_expired":
        return {k: v for k, v in r.items() if k != "message"}
    return r


def _same_service(js, ts, *, tol=1e-12):
    """Equal serving counters, shed reasons, per-session sweeps and edges,
    and ranks within ``tol``."""
    rj, rt = js.report(), ts.report()
    for key in ("requests_done", "requests_queued", "requests_shed",
                "shed_reasons", "deadline_misses", "retries", "n_sessions",
                "serving"):
        assert rt[key] == rj[key], (key, rt[key], rj[key])
    assert ([f["replayed_batches"] for f in rt["failovers"]]
            == [f["replayed_batches"] for f in rj["failovers"]])
    assert ([_reason(r.shed_reason) for r in ts.shed_requests]
            == [_reason(r.shed_reason) for r in js.shed_requests])
    assert [r.uid for r in ts.finished] == [r.uid for r in js.finished]
    assert len(rt["sessions"]) == len(rj["sessions"])
    for a, b in zip(rt["sessions"], rj["sessions"]):
        if b.get("closed"):
            assert a == b
            continue
        for key in ("n", "n_updates", "total_sweeps",
                    "total_edges_processed", "sweeps_history",
                    "edges_processed_history", "batches_converged",
                    "sweep_cap_hits", "queries_served", "driver"):
            assert a[key] == b[key], (key, a[key], b[key])
        assert a["retraces_post_warmup"] == 0
        assert "bucket_retraces_post_warmup" not in a
    for sj, st in zip(js.sessions, ts.sessions):
        assert (sj is None) == (st is None)
        if sj is not None and not sj.closed:
            assert np.abs(st.ranks - np.asarray(sj.R)).max() <= tol


def _oracle_linf(ranks, cur) -> float:
    ref = jpr.numpy_reference(cur.snapshot(block_size=BLOCK), iterations=300)
    return float(np.abs(ranks[:cur.n] - ref[:cur.n]).max())


@pytest.fixture(scope="module")
def hgs():
    return _graphs(jrmat, rmat, 8, avg_degree=5, seed=11)


# ---------------------------------------------------------------------------
# twins of tests/test_service_overload.py: admission control + shedding
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_reject_policy_raises_with_machine_readable_reason(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False,
                           serving=dict(max_queue_depth=2))
        bs, _ = _batches(jg, 3)
        for d, ins in bs[:2]:
            js.submit(0, d, ins)
            ts.submit(0, d, ins)
        with pytest.raises(JRejected) as ej:
            js.submit(0, *bs[2])
        with pytest.raises(AdmissionRejected) as et:
            ts.submit(0, *bs[2])
        reason = et.value.reason
        assert reason == ej.value.reason
        assert str(et.value) == str(ej.value)
        assert reason["code"] == "queue_full"
        assert reason["stream"] == 0
        assert reason["queue_depth"] == 2
        assert reason["max_queue_depth"] == 2
        assert reason["shed_policy"] == "reject"
        assert len(ts.queue) == 2
        rep = ts.report()
        assert rep["requests_shed"] == 1
        assert rep["shed_reasons"] == {"queue_full": 1}
        _same_service(js, ts)

    def test_drop_oldest_policy_sheds_head_keeps_newest(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False,
                           serving=dict(max_queue_depth=2,
                                        shed_policy="drop_oldest"))
        bs, _ = _batches(jg, 3)
        uids = [ts.submit(0, d, ins) for d, ins in bs]
        assert [js.submit(0, d, ins) for d, ins in bs] == uids
        assert [r.uid for r in ts.queue] == uids[1:]
        shed = ts.shed_requests[0]
        assert shed.uid == uids[0]
        assert shed.shed_reason["code"] == "queue_full_dropped_oldest"
        assert ts.report()["shed_reasons"] == {"queue_full_dropped_oldest": 1}
        _same_service(js, ts)
        js.run_until_drained()
        ts.run_until_drained()
        _same_service(js, ts)


# ---------------------------------------------------------------------------
# deadlines + retries
# ---------------------------------------------------------------------------

class TestDeadlines:
    def test_expired_queued_request_is_shed_before_dispatch(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False)
        bs, _ = _batches(jg, 1)
        uid = ts.submit(0, *bs[0], deadline_s=1e-4)
        assert js.submit(0, *bs[0], deadline_s=1e-4) == uid
        time.sleep(0.01)
        assert ts.step() == 0 and js.step() == 0
        assert ts.sessions[0].report().n_updates == 0
        shed = ts.shed_requests[0]
        assert shed.uid == uid
        assert shed.shed_reason["code"] == "deadline_expired"
        rep = ts.report()
        assert rep["deadline_misses"] == 1
        assert rep["requests_shed"] == 1
        _same_service(js, ts)

    def test_late_completion_counts_as_deadline_miss(self, hgs):
        jg, tg = hgs
        svc = PageRankService([tg], config=EngineConfig(**_kw()), device=CPU)
        sess = svc.sessions[0]
        orig = sess.update

        def slow_update(d, i, **kw):
            time.sleep(0.08)
            return orig(d, i, **kw)

        sess.update = slow_update
        bs, _ = _batches(jg, 1)
        svc.submit(0, *bs[0], deadline_s=0.03)
        svc.run_until_drained()
        req = svc.finished[0]
        assert req.done and req.deadline_missed
        assert svc.report()["deadline_misses"] == 1

    def test_transient_failure_retries_with_backoff(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg],
                           serving=dict(max_retries=2, retry_backoff_s=1e-3))
        for svc in (js, ts):
            sess = svc.sessions[0]
            orig, calls = sess.update, {"n": 0}

            def flaky_update(d, i, _orig=orig, _calls=calls, **kw):
                _calls["n"] += 1
                if _calls["n"] == 1:
                    raise RuntimeError("transient device hiccup")
                return _orig(d, i, **kw)

            sess.update = flaky_update
        bs, cur = _batches(jg, 1)
        js.submit(0, *bs[0])
        ts.submit(0, *bs[0])
        js.run_until_drained()
        done = ts.run_until_drained()
        assert len(done) == 1 and done[0].done
        assert done[0].attempts == 2 == js.finished[0].attempts
        assert ts.report()["retries"] == 1
        assert _oracle_linf(ts.sessions[0].ranks, cur) < 1e-8
        _same_service(js, ts)


# ---------------------------------------------------------------------------
# degraded-mode reads
# ---------------------------------------------------------------------------

class TestDegradedReads:
    def test_reads_report_bounded_staleness(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg],
                           serving=dict(staleness_budget_s=10.0))
        bs, _ = _batches(jg, 2)
        for d, ins in bs:
            js.submit(0, d, ins)
            ts.submit(0, d, ins)
        js.run_until_drained()
        ts.run_until_drained()
        res = ts.query(0, [0, 1, 2])
        assert isinstance(res, ReadResult)
        assert res.degraded
        assert res.staleness_s >= 0.0
        assert res.lag_updates == 0     # view refreshed after dispatch
        assert np.asarray(res).shape == (3,)
        np.testing.assert_array_equal(
            np.asarray(res), ts.sessions[0].query([0, 1, 2]))
        js.sessions[0].query([0, 1, 2])
        jres = js.query(0, [0, 1, 2])
        assert np.abs(np.asarray(res) - np.asarray(jres)).max() <= 1e-12
        vals, verts = ts.top_k(0, 4)    # tuple-unpacks like the session
        jvals, jverts = js.top_k(0, 4)
        assert vals.shape == (4,) and verts.shape == (4,)
        np.testing.assert_array_equal(verts, np.asarray(jverts))
        assert np.abs(vals - np.asarray(jvals)).max() <= 1e-12
        q = ts.report()["queries"]
        assert q["served"] == 2 == js.report()["queries"]["served"]
        assert q["staleness_max_s"] >= 0.0
        _same_service(js, ts)

    def test_stale_snapshot_refreshes_when_idle(self, hgs):
        jg, tg = hgs
        svc = PageRankService([tg], config=EngineConfig(**_kw()), device=CPU,
                              serving=ServingConfig(staleness_budget_s=0.01))
        bs, _ = _batches(jg, 1)
        svc.submit(0, *bs[0])
        svc.run_until_drained()
        time.sleep(0.05)                # the view goes stale past budget
        res = svc.query(0, [0])
        assert res.staleness_s <= 0.05  # refreshed at read time
        assert res.lag_updates == 0
        assert svc.report()["queries"]["snapshot_refreshes"] == 1

    def test_reads_survive_slot_death(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False,
                           serving=dict(watchdog=False))
        before = np.asarray(ts.query(0, [0, 1]))
        jbefore = np.asarray(js.query(0, [0, 1]))
        for svc in (js, ts):
            sess = svc.sessions[0]
            sess._service = None        # crash-stop, not a clean close
            sess.close()
        res = ts.query(0, [0, 1])       # still served, from the view
        assert res.degraded
        np.testing.assert_array_equal(np.asarray(res), before)
        assert np.abs(np.asarray(js.query(0, [0, 1])) - np.asarray(res)
                      ).max() <= 1e-12
        assert np.abs(before - jbefore).max() <= 1e-12

    def test_disabled_degraded_reads_serve_live(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False,
                           serving=dict(degraded_reads=False))
        res = ts.query(0, [0])
        jres = js.query(0, [0])
        assert not res.degraded and not jres.degraded
        assert res.staleness_s == 0.0
        assert abs(float(res.values[0]) - float(jres.values[0])) <= 1e-12
        assert ts.sessions[0].report().queries_served == 1


# ---------------------------------------------------------------------------
# input validation before scatter / WAL
# ---------------------------------------------------------------------------

class TestInputValidation:
    BAD = [
        (np.array([[0, np.nan]]), "non-finite"),
        (np.array([[0, np.inf]]), "non-finite"),
        (np.array([[0.5, 1.0]]), "non-integral"),
        (np.array([[0, 10 ** 6]]), "out-of-range"),
        (np.array([[-1, 2]]), "out-of-range"),
        (np.array([[1, 2], [1, 2]]), "duplicate"),
        (np.array([[1, 2, 3]]), "edge pairs"),
        (np.array([["a", "b"]], dtype=object), "object"),
    ]

    @pytest.mark.parametrize("bad,msg", BAD)
    def test_session_update_rejects_malformed(self, hgs, bad, msg):
        jg, tg = hgs
        js = JSession.from_graph(jg, config=JConfig(**_kw()))
        ts = PageRankSession.from_graph(tg, config=EngineConfig(**_kw()),
                                        device=CPU)
        with pytest.raises(ValueError, match=msg) as ej:
            js.update(np.zeros((0, 2)), bad)
        with pytest.raises(ValueError, match=msg) as et:
            ts.update(np.zeros((0, 2)), bad)
        assert str(et.value) == str(ej.value)
        assert ts.report().n_updates == 0     # nothing applied

    def test_self_loop_and_del_ins_overlap_rejected(self, hgs):
        _, tg = hgs
        sess = PageRankSession.from_graph(tg, config=EngineConfig(**_kw()),
                                          device=CPU)
        with pytest.raises(ValueError, match="self-loop"):
            sess.update(np.zeros((0, 2)), np.array([[3, 3]]))
        with pytest.raises(ValueError, match="both deletions"):
            sess.update(np.array([[1, 2]]), np.array([[1, 2]]))
        assert sess.report().n_updates == 0

    def test_service_rejects_at_admission_not_in_queue(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg], warmup=False)
        bad = (np.zeros((0, 2)), np.array([[0, np.nan]]))
        with pytest.raises(ValueError, match="non-finite") as ej:
            js.submit(0, *bad)
        with pytest.raises(ValueError, match="non-finite") as et:
            ts.submit(0, *bad)
        assert str(et.value) == str(ej.value)
        assert ts.queue == []           # never admitted
        _same_service(js, ts)

    def test_bad_batch_never_reaches_wal(self, hgs, tmp_path):
        jg, tg = hgs
        good, cur = _batches(jg, 1, seed0=33)
        twins = []
        for name, cls, cfg, g, kw in (
                ("j", JSession, JConfig, jg, {}),
                ("t", PageRankSession, EngineConfig, tg, {"device": CPU})):
            store = str(tmp_path / name)
            sess = cls.from_graph(g, config=cfg(**_kw(durability="wal")),
                                  store_dir=store, **kw)
            sess.update(*good[0])
            with pytest.raises(ValueError, match="out-of-range"):
                sess.update(np.zeros((0, 2)), np.array([[0, 10 ** 6]]))
            sess.close()
            # the restore replays exactly the one good batch
            twin = cls.restore(store, **kw)
            assert twin._batch_index == 1
            twins.append(np.asarray(twin.ranks))
        assert _oracle_linf(twins[1], cur) < 1e-8
        assert np.abs(twins[1] - twins[0]).max() <= 1e-12


# ---------------------------------------------------------------------------
# sweep-cap surfacing
# ---------------------------------------------------------------------------

class TestSweepCap:
    def test_capped_update_warns_and_reports(self, hgs):
        jg, tg = hgs
        bs, _ = _batches(jg, 1, seed0=70)
        js = JSession.from_graph(jg, config=JConfig(**_kw(max_iterations=1)))
        with pytest.warns(JSweepCapWarning, match="max_iterations"):
            jres = js.update(*bs[0])
        sess = PageRankSession.from_graph(
            tg, config=EngineConfig(**_kw(max_iterations=1)), device=CPU)
        with pytest.warns(SweepCapWarning, match="max_iterations"):
            res = sess.update(*bs[0])
        assert not res.converged and not jres.converged
        rep = sess.report()
        assert rep.sweep_cap_hits == 1
        assert rep.batches_converged == 0
        assert rep.total_sweeps == js.report().total_sweeps

    def test_converged_update_does_not_warn(self, hgs):
        jg, tg = hgs
        bs, _ = _batches(jg, 1, seed0=71)
        sess = PageRankSession.from_graph(tg, config=EngineConfig(**_kw()),
                                          device=CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("error", SweepCapWarning)
            res = sess.update(*bs[0])
        assert res.converged
        rep = sess.report()
        assert rep.sweep_cap_hits == 0 and rep.batches_converged == 1

    def test_run_stream_aggregates_convergence(self, hgs):
        from repro.core.stream import run_stream as jrun_stream
        jg, tg = hgs
        bs, _ = _batches(jg, 3, seed0=72)
        rep = run_stream(tg, bs, block_size=BLOCK, device=CPU)
        jrep = jrun_stream(jg, bs, block_size=BLOCK)
        assert rep.batches_converged == 3 == jrep.batches_converged
        assert rep.sweep_cap_hits == 0 and rep.all_converged


# ---------------------------------------------------------------------------
# chaos under load: watchdog failover drains the queue to the respawn
# ---------------------------------------------------------------------------

class TestFailoverUnderLoad:
    @staticmethod
    def _durable_pair(hgs, tmp_path, name):
        jg, tg = hgs
        kw = _kw(durability="wal", checkpoint_interval=2)
        js = JSession.from_graph(jg, config=JConfig(**kw),
                                 store_dir=str(tmp_path / name / "j"))
        ts = PageRankSession.from_graph(tg, config=EngineConfig(**kw),
                                        device=CPU,
                                        store_dir=str(tmp_path / name / "t"))
        return js, ts

    def test_dead_slot_drains_to_respawn_sync(self, hgs, tmp_path):
        a, b = self._durable_pair(hgs, tmp_path, "dead")
        js, ts = JService([a]), PageRankService([b])
        bs, cur = _batches(hgs[0], 3, seed0=50)
        for svc in (js, ts):
            svc.inject_session_fault(0, after_dispatches=1, kind="dead")
            for d, ins in bs:           # interleave so the fault fires
                svc.submit(0, d, ins)
                svc.step()
        js.run_until_drained()
        done = ts.run_until_drained()
        assert len(done) == 3 and all(r.done for r in done)
        rep, jrep = ts.report(), js.report()
        events = rep["watchdog"]
        assert len(events) == 1
        assert events[0]["kind"] == "dead"
        assert events[0]["domain"] == "session"
        assert events[0]["drained_requests"] >= 1
        for key in ("kind", "domain", "drained_requests", "replayed_batches",
                    "batch_index", "stream"):
            assert events[0][key] == jrep["watchdog"][0][key], key
        # the process-domain restore itself + the session-domain drain
        assert rep["sessions"][0]["recoveries"] == 2
        assert ts.sessions[0].device == torch.device(CPU)
        assert _oracle_linf(ts.sessions[0].ranks, cur) < 1e-8
        _same_service(js, ts)

    def test_stuck_slot_fails_over_under_background_load(self, hgs,
                                                         tmp_path):
        _, b = self._durable_pair(hgs, tmp_path, "stuck")
        svc = PageRankService(
            [b], serving=ServingConfig(heartbeat_timeout_s=1.0))
        svc.inject_session_fault(0, after_dispatches=1, kind="stuck",
                                 stall_s=6.0)
        svc.start()
        try:
            bs, cur = _batches(hgs[0], 4, seed0=60)
            for d, ins in bs:
                svc.submit(0, d, ins)
                time.sleep(0.15)
        finally:
            svc.stop()
        rep = svc.report()
        assert rep["requests_done"] == 4
        assert rep["requests_queued"] == 0
        events = rep["watchdog"]
        assert events and events[0]["kind"] == "stuck"
        assert events[0]["drained_requests"] >= 1
        assert _oracle_linf(svc.sessions[0].ranks, cur) < 1e-8

    def test_failover_drain_orders_stranded_before_midrecovery_submits(
            self, hgs, tmp_path):
        # the drain must PREPEND the stranded run: stranded delete(e) +
        # mid-recovery insert(e) nets to e present only in submit order
        jg, tg = hgs
        a, b = self._durable_pair(hgs, tmp_path, "order")
        js, ts = JService([a]), PageRankService([b])
        e = jg.edges[:1]                    # one existing edge
        none = np.zeros((0, 2), np.int64)
        for svc in (js, ts):
            svc.inject_session_fault(0, after_dispatches=0, kind="dead")
            orig_failover = svc.failover

            def failover_then_submit(stream, _svc=svc, _orig=orig_failover,
                                     **kw):
                out = _orig(stream, **kw)
                _svc.submit(0, none, e)     # re-insert e mid-recovery
                return out

            svc.failover = failover_then_submit
            svc.submit(0, e, none)          # delete e (stranded by kill)
            svc.step()          # dispatch dies; watchdog drains + respawns
        js.run_until_drained()
        done = ts.run_until_drained()
        assert len(done) == 2 and all(r.done for r in done)
        assert ts.sessions[0].hg.has_edges(e).all()
        assert _oracle_linf(ts.sessions[0].ranks, jg) < 1e-8
        _same_service(js, ts)

    def test_dead_slot_without_store_sheds_with_reason(self, hgs):
        jg, tg = hgs
        js, ts = _services([jg], [tg])      # no durability
        bs, _ = _batches(jg, 2, seed0=65)
        for svc in (js, ts):
            svc.inject_session_fault(0, after_dispatches=0, kind="dead")
            for d, ins in bs:
                svc.submit(0, d, ins)
            svc.run_until_drained(max_ticks=20)
        rep = ts.report()
        assert rep["requests_done"] == 0
        assert rep["requests_shed"] == 2
        assert rep["shed_reasons"] == {"slot_dead": 2}
        assert rep["watchdog"] and \
            "no store" in rep["watchdog"][0]["description"]
        assert ([r.error for r in ts.shed_requests]
                == [r.error for r in js.shed_requests])
        _same_service(js, ts)


# ---------------------------------------------------------------------------
# twins of tests/test_api_session.py::TestService and the close hook
# ---------------------------------------------------------------------------

class TestService:
    def test_drains_and_reports_per_session(self):
        pairs = [_graphs(jrmat, rmat, 8, avg_degree=4, seed=s)
                 for s in (0, 1)]
        js, ts = _services([p[0] for p in pairs], [p[1] for p in pairs],
                           serving=dict(coalesce=False))
        cur = [p[0] for p in pairs]
        for j in range(2):
            for i in range(len(cur)):
                dels, ins = random_batch(cur[i], 1e-2, seed=50 + 10 * i + j)
                js.submit(i, dels, ins)
                ts.submit(i, dels, ins)
                cur[i] = cur[i].apply_batch(dels, ins)
        js.run_until_drained()
        done = ts.run_until_drained()
        assert len(done) == 4
        assert all(r.done and r.result.stats.converged for r in done)
        assert all(r.latency_s >= r.wait_s >= 0 for r in done)
        rep = ts.report()
        assert rep["requests_done"] == 4 and rep["requests_queued"] == 0
        for row in rep["sessions"]:
            assert row["n_updates"] == 2
            assert row["retraces_post_warmup"] == 0
            assert row["devices"] == [0]
        for i, hg in enumerate(cur):
            assert _oracle_linf(ts.sessions[i].ranks, hg) < 1e-8
        _same_service(js, ts)

    def test_step_coalesces_queue_into_one_update(self):
        jg, tg = _graphs(jrmat, rmat, 8, avg_degree=4, seed=2)
        js, ts = _services([jg], [tg])
        cur = jg
        for j in range(3):
            dels, ins = random_batch(cur, 1e-2, seed=90 + j)
            js.submit(0, dels, ins)
            ts.submit(0, dels, ins)
            cur = cur.apply_batch(dels, ins)
        assert js.step() == 3
        assert ts.step() == 3       # whole run retires in ONE dispatch
        assert ts.queue == []
        assert [r.uid for r in ts.finished] == [1, 2, 3]
        assert ts.sessions[0].report().n_updates == 1  # one scatter
        assert _oracle_linf(ts.sessions[0].ranks, cur) < 1e-8
        _same_service(js, ts)

    def test_fifo_per_stream_without_coalescing(self):
        jg, tg = _graphs(jrmat, rmat, 8, avg_degree=4, seed=2)
        js, ts = _services([jg], [tg], serving=dict(coalesce=False))
        cur = jg
        for j in range(3):
            dels, ins = random_batch(cur, 1e-2, seed=90 + j)
            js.submit(0, dels, ins)
            ts.submit(0, dels, ins)
            cur = cur.apply_batch(dels, ins)
        assert ts.step() == 1 == js.step()  # one batch per slot per pass
        assert len(ts.queue) == 2
        assert [r.uid for r in ts.finished] == [1]
        js.run_until_drained()
        ts.run_until_drained()
        assert [r.uid for r in ts.finished] == [1, 2, 3]
        _same_service(js, ts)

    def test_submit_bad_stream_rejected(self):
        jg, tg = _graphs(jrmat, rmat, 7, avg_degree=4, seed=0)
        js, ts = _services([jg], [tg], warmup=False)
        with pytest.raises(ValueError, match="out of range") as ej:
            js.submit(3, np.zeros((0, 2)), np.zeros((0, 2)))
        with pytest.raises(ValueError, match="out of range") as et:
            ts.submit(3, np.zeros((0, 2)), np.zeros((0, 2)))
        assert str(et.value) == str(ej.value)


def test_close_unregisters_from_service():
    pairs = [_graphs(jrmat, rmat, 7, avg_degree=4, seed=s) for s in (0, 1)]
    js, ts = _services([p[0] for p in pairs], [p[1] for p in pairs],
                       warmup=False)
    z = np.zeros((0, 2))
    for svc in (js, ts):
        assert set(svc.placements()) == {0, 1}
        svc.submit(0, z, z)
        svc.sessions[0].close()
        assert svc.sessions[0] is None
        assert svc.queue == []                  # queued batches dropped
        assert set(svc.placements()) == {1}
        with pytest.raises(ValueError, match="closed"):
            svc.submit(0, z, z)
        svc.submit(1, z, z)                     # slot 1 lives
        assert svc.step() == 1
    rep = ts.report()
    assert rep["sessions"][0] == {"stream": 0, "closed": True}
    assert rep["sessions"][1]["devices"]
    assert ts.placements() == js.placements()
    _same_service(js, ts)


# ---------------------------------------------------------------------------
# twin of test_fault_domains.py::test_service_failover_respawns_from_store
# ---------------------------------------------------------------------------

def test_service_failover_respawns_from_store(tmp_path):
    jg, tg = _graphs(jkmer_chains, kmer_chains, 1 << 10, seed=4)
    r0 = jpr.numpy_reference(jg.snapshot(block_size=BLOCK), iterations=300)
    batches, _ = _batches(jg, 4, seed0=100)
    lone = PageRankSession.from_graph(tg, config=EngineConfig(**_kw()),
                                      r0=r0, device=CPU)
    oracle = []
    for d, ins in batches:
        lone.update(d, ins)
        oracle.append(lone.ranks)
    kw = _kw(durability="wal", checkpoint_interval=3)
    svcs = []
    for name, S, Svc, C, V, g, dev in (
            ("j", JSession, JService, JConfig, JServing, jg, {}),
            ("t", PageRankSession, PageRankService, EngineConfig,
             ServingConfig, tg, {"device": CPU})):
        durable = S.from_graph(g, config=C(**kw), r0=r0,
                               store_dir=str(tmp_path / name), **dev)
        other = S.from_graph(g, config=C(**_kw()), r0=r0, **dev)
        # coalesce=False: the bit-for-bit check below needs the WAL to hold
        # the same 3-batch sequence it replays
        svc = Svc([durable, other], warmup=False,
                  serving=V(coalesce=False))
        for i in range(3):
            svc.submit(0, *batches[i])
            svc.submit(1, *batches[i])
        svc.run_until_drained()
        durable.close()                  # the slot dies
        with pytest.raises(ValueError, match="closed"):
            svc.submit(0, *batches[3])
        with pytest.raises(ValueError, match="still live"):
            svc.failover(1)              # live slots are not replaced
        other.close()
        with pytest.raises(ValueError, match="no durable store"):
            svc.failover(1)              # non-durable slot cannot respawn
        row = svc.failover(0)
        assert row["restored_batch_index"] == 3
        assert row["recovery_time_s"] > 0
        svc.submit(0, *batches[3])
        svc.run_until_drained()
        svcs.append(svc)
    js, ts = svcs
    np.testing.assert_array_equal(ts.sessions[0].ranks, oracle[3])
    rep = ts.report()
    assert rep["failovers"] and rep["failovers"][0]["stream"] == 0
    assert rep["sessions"][0]["durability"] == "wal"
    assert rep["sessions"][0]["recoveries"] == 1
    with pytest.raises(ValueError, match="still live"):
        ts.failover(0)
    _same_service(js, ts)


# ---------------------------------------------------------------------------
# port-only: ServingConfig, the read view, device placement, later items
# ---------------------------------------------------------------------------

BAD_SERVING = [
    dict(max_queue_depth=0), dict(shed_policy="lifo"), dict(deadline_s=-1),
    dict(max_retries=-1), dict(retry_backoff_s=-0.5),
    dict(staleness_budget_s=-1.0), dict(snapshot_refresh_frac=0.0),
    dict(snapshot_refresh_frac=1.5), dict(heartbeat_timeout_s=0),
]


@pytest.mark.parametrize("kw", BAD_SERVING,
                         ids=[next(iter(k)) + "=" + str(next(iter(k.values())))
                              for k in BAD_SERVING])
def test_serving_config_errors_match_reference(kw):
    with pytest.raises(ValueError) as ej:
        JServing(**kw)
    with pytest.raises(ValueError) as et:
        ServingConfig(**kw)
    assert str(et.value) == str(ej.value)


def test_serving_config_fields_defaults_and_replace():
    assert ServingConfig.valid_keys() == JServing.valid_keys()
    assert (vars(ServingConfig()) == vars(JServing()))
    cfg = ServingConfig().replace(coalesce=False, max_queue_depth=3)
    assert (cfg.coalesce, cfg.max_queue_depth) == (False, 3)
    with pytest.raises(TypeError) as ej:
        JServing().replace(coalese=False)
    with pytest.raises(TypeError) as et:
        ServingConfig().replace(coalese=False)
    assert str(et.value) == str(ej.value)
    with pytest.raises(TypeError, match="ServingConfig"):
        PageRankService([rmat(7, seed=0)], serving=dict(coalesce=False),
                        device=CPU)


def test_read_view_owns_its_storage_and_holds_only_ranks(hgs):
    jg, tg = hgs
    svc = PageRankService([tg], config=EngineConfig(**_kw()), device=CPU)
    sess = svc.sessions[0]
    view = svc._snapshots[0].sess
    assert isinstance(view, ReadView)
    # the view holds R and valid, as clones, and nothing of the matrix
    assert view.nbytes == sess.R.nbytes + sess.valid.nbytes
    assert {s for s in ReadView.__slots__
            if isinstance(getattr(view, s), torch.Tensor)} == {"R", "valid"}
    assert view.R.untyped_storage().data_ptr() != \
        sess.R.untyped_storage().data_ptr()
    assert view.valid.untyped_storage().data_ptr() != \
        sess.valid.untyped_storage().data_ptr()
    assert view.ready is None                       # no events on the CPU
    ids = [0, 5, 17]
    np.testing.assert_array_equal(view.query(ids), sess.query(ids))
    for a, b in zip(view.top_k(7), sess.top_k(7)):
        np.testing.assert_array_equal(a, b)
    for bad in ([sess.n], [-1], [0.5]):
        with pytest.raises(ValueError) as ev:
            view.query(bad)
        with pytest.raises(ValueError) as es:
            sess.query(bad)
        assert str(ev.value) == str(es.value)
    for bad in (0, 2.0):
        with pytest.raises(ValueError) as ev:
            view.top_k(bad)
        with pytest.raises(ValueError) as es:
            sess.top_k(bad)
        assert str(ev.value) == str(es.value)
    # a rank written in place on the live copy does not reach the view
    before = view.query(ids)
    sess.R[ids[0]] += 1.0
    np.testing.assert_array_equal(view.query(ids), before)
    sess.R[ids[0]] -= 1.0
    # a service read counts once for the live session, the view never
    q0 = sess._queries
    svc.query(0, ids)
    svc.top_k(0, 3)
    assert sess._queries == q0 + 2
    # after close() the view still serves
    sess._service = None
    sess.close()
    np.testing.assert_array_equal(np.asarray(svc.query(0, ids)), before)


def test_dispatch_refreshes_view_at_the_batch_index(hgs):
    jg, tg = hgs
    svc = PageRankService([tg], config=EngineConfig(**_kw()), device=CPU,
                          serving=ServingConfig(coalesce=False))
    bs, _ = _batches(jg, 2, seed0=5)
    for d, ins in bs:
        svc.submit(0, d, ins)
    assert svc._snapshots[0].sess.batch_index == 0
    svc.step()
    snap = svc._snapshots[0]
    assert snap.sess.batch_index == 1
    np.testing.assert_array_equal(snap.sess.R.numpy(),
                                  svc.sessions[0].R.numpy())
    svc.step()
    assert svc._snapshots[0].sess.batch_index == 2


def test_busy_slot_redates_a_current_view_only(hgs):
    """Past the refresh point a read of a dispatching slot (its lock held)
    keeps the view and dates it to now while nothing committed past it; once
    the live session is ahead of the view, it serves it as it is, stale."""
    jg, tg = hgs
    svc = PageRankService([tg], config=EngineConfig(**_kw()), device=CPU,
                          serving=ServingConfig(staleness_budget_s=0.01))
    sess, snap = svc.sessions[0], svc._snapshots[0]
    time.sleep(0.02)
    with svc._slot_locks[0]:
        res = svc.query(0, [0])
        redated = svc._snapshots[0]
        assert redated.sess is snap.sess and redated.taken_s > snap.taken_s
        assert res.staleness_s == 0.0 and res.lag_updates == 0
        time.sleep(0.02)
        sess._batch_index += 1      # a commit the view has not seen
        res = svc.query(0, [0])
        assert svc._snapshots[0] is redated
        assert res.lag_updates == 1 and res.staleness_s >= 0.02
        sess._batch_index -= 1
    assert svc.report()["queries"]["snapshot_refreshes"] == 1


def test_cpu_slot_fails_over_onto_cpu(hgs, tmp_path):
    jg, tg = hgs
    sess = PageRankSession.from_graph(
        tg, config=EngineConfig(**_kw(durability="wal")), device=CPU,
        store_dir=str(tmp_path / "s"))
    svc = PageRankService([sess], serving=ServingConfig(coalesce=False))
    assert svc._streams == {0: None}
    bs, _ = _batches(jg, 2, seed0=7)
    svc.submit(0, *bs[0])
    svc.run_until_drained()
    expect = sess.ranks
    sess._service = None
    sess.close()
    row = svc.failover(0)
    assert row["restored_batch_index"] == 1
    new = svc.sessions[0]
    assert new.device == torch.device(CPU) and new.R.device.type == CPU
    assert new._service is svc
    np.testing.assert_array_equal(new.ranks, expect)
    np.testing.assert_array_equal(np.asarray(svc.query(0, [0, 1])),
                                  expect[[0, 1]])


def test_repair_restore_rung_keeps_the_service_backref(hgs, tmp_path):
    jg, tg = hgs
    sess = PageRankSession.from_graph(
        tg, device=CPU, store_dir=str(tmp_path / "s"),
        config=EngineConfig(**_kw(
            durability="wal", active_policy="rc", max_iterations=2000,
            integrity=IntegrityConfig(auto_repair=False))))
    svc = PageRankService([sess], serving=ServingConfig(coalesce=False,
                                                        scrub=False))
    sess.inject_corruption("graph", seed=1)
    rep = svc.scrub(0, repair=True)[0]
    assert "restore" in rep.repairs and rep.ok
    assert sess._service is svc and sess.fork()._service is None
    sess.close()                    # unregisters through the kept backref
    assert svc.sessions[0] is None


def test_ppr_query_names_a_13(hgs):
    """``ppr_query`` raised naming ROADMAP A 13 until the walk engine was
    ported; a walk slot now serves it as the reference's does."""
    jg, tg = hgs
    kw = dict(engine="walk", walks_per_vertex=4, walk_length=16)
    jsvc = JService([jg], config=JConfig(**kw))
    svc = PageRankService([tg], config=EngineConfig(**kw), device=CPU)
    try:
        for s in (jsvc, svc):
            s.submit(0, np.zeros((0, 2), np.int64), np.array([[0, 9]]))
            while s.step():
                pass
        a, b = jsvc.ppr_query(0, [0, 3], 5), svc.ppr_query(0, [0, 3], 5)
        assert b.degraded and b.lag_updates == 0
        assert np.array_equal(a.values, b.values)
        assert np.array_equal(a.vertices, b.vertices)
    finally:
        svc.stop()
        jsvc.stop()


def test_host_graphs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device opens there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PageRankService([rmat(7, seed=0)])
