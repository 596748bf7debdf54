"""The service's integrity scrubber and the chaos soak of the port against
the JAX package's.

Twins of ``tests/test_integrity.py::test_service_scrub_detects_and_repairs``,
``::test_background_scrubber_thread`` and ``::test_chaos_plan_soak`` keep
its graphs (each package's own ``rmat``, same seeds), configs (B = 64, f64,
``active_policy="rc"``) and serving policies.  The synchronous scrub and
the soak run the reference's service and the port's (``device="cpu"``)
side by side and assert the same failure dicts, rungs and per-slot repairs,
equal ``report()["integrity"]``, and ranks within 1e-12 of the reference's
and 1e-9 of the numpy oracle.  The background scrubber's timing is its
own, so that twin asserts what the reference test asserts, on the port
alone.
"""
import time

import numpy as np
import pytest
import torch

from repro.api import ChaosPlan as JChaosPlan
from repro.api import EngineConfig as JConfig
from repro.api import IntegrityConfig as JIntegrity
from repro.api import PageRankService as JService
from repro.api import PageRankSession as JSession
from repro.api import ServingConfig as JServing
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import rmat as jrmat
from repro_torch.api import (ChaosPlan, EngineConfig, IntegrityConfig,
                             PageRankService, PageRankSession, ServingConfig)
from repro_torch.graphs.generators import rmat

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


def _kw(*, auto_repair=False, integrity_kw=None, **over):
    base = dict(engine="pallas", block_size=BS, active_policy="rc",
                max_iterations=2000)
    base.update(over)
    icfg = dict(auto_repair=auto_repair, **(integrity_kw or {}))
    return base, icfg


def _graph_pair(*args, **kw):
    jg, tg = jrmat(*args, **kw), rmat(*args, **kw)
    assert tg.n == jg.n and np.array_equal(tg.edges, jg.edges)
    return jg, tg


def _sessions(seeds, n_log2, *, store=None, **cfg):
    """One reference session and one port session per seed, on each
    package's ``rmat(n_log2, avg_degree=6, seed=s)``."""
    base, icfg = _kw(**cfg)
    js, ts = [], []
    for i, s in enumerate(seeds):
        jg, tg = _graph_pair(n_log2, avg_degree=6, seed=s)
        store_j = None if store is None else str(store / f"j{i}")
        store_t = None if store is None else str(store / f"t{i}")
        js.append(JSession.from_graph(
            jg, config=JConfig(**base, integrity=JIntegrity(**icfg)),
            store_dir=store_j))
        ts.append(PageRankSession.from_graph(
            tg, config=EngineConfig(**base,
                                    integrity=IntegrityConfig(**icfg)),
            device=CPU, store_dir=store_t))
    return js, ts


def _same_report(rj, rt):
    assert len(rt.failures) == len(rj.failures), (rt.failures, rj.failures)
    for x, y in zip(rj.failures, rt.failures):
        assert x.keys() == y.keys(), (x, y)
        for k in x:
            if k in FLOAT_FIELDS:
                assert abs(float(x[k]) - float(y[k])) <= 1e-12, (k, x, y)
            else:
                assert x[k] == y[k], (k, x, y)
    assert rt.repairs == rj.repairs
    assert (rt.ok, rt.checks_run) == (rj.ok, rj.checks_run)


def _same_scrub(out_j, out_t):
    assert set(out_t) == set(out_j)
    for i in out_j:
        _same_report(out_j[i], out_t[i])


def _same_ranks(js, ts, tol=1e-12):
    for sj, st in zip(js.sessions, ts.sessions):
        assert np.abs(st.ranks - np.asarray(sj.R)).max() <= tol


def test_service_scrub_detects_and_repairs():
    js_, ts_ = _sessions([20, 21], 8)
    sv = dict(coalesce=False, scrub=False)
    js = JService(js_, serving=JServing(**sv))
    ts = PageRankService(ts_, serving=ServingConfig(**sv))
    js.sessions[1].inject_corruption("mirror", seed=9)
    ts.sessions[1].inject_corruption("mirror", seed=9)
    rj = js.scrub(deep=True, repair=True)
    reports = ts.scrub(deep=True, repair=True)
    _same_scrub(rj, reports)
    assert set(reports) == {0, 1}
    assert reports[0].ok and not reports[0].failures
    assert reports[1].failures and reports[1].ok
    out = ts.report()
    assert out["integrity"] == js.report()["integrity"]
    assert out["integrity"]["scrubs_run"] >= 1
    assert out["integrity"]["corruption_detected"] == 1
    assert out["integrity"]["repairs"].get("rebuild", 0) >= 1
    _same_ranks(js, ts)
    # the repaired state serves at once: the read view was refreshed
    np.testing.assert_array_equal(np.asarray(ts.query(1, [0, 1, 2])),
                                  ts.sessions[1].query([0, 1, 2]))
    js.stop()
    ts.stop()


def test_background_scrubber_thread():
    """With ``ServingConfig(scrub=True)`` a daemon scrubber sweeps idle
    slots at each slot's ``scrub_interval_s`` and repairs what it finds."""
    base, icfg = _kw(auto_repair=True, integrity_kw=dict(
        scrub_interval_s=0.02))
    sessions = [PageRankSession.from_graph(
        rmat(8, avg_degree=6, seed=30 + s),
        config=EngineConfig(**base, integrity=IntegrityConfig(**icfg)),
        device=CPU) for s in range(2)]
    svc = PageRankService(
        sessions, serving=ServingConfig(coalesce=False, scrub=True))
    svc.start()
    try:
        svc.sessions[0].inject_corruption("rank", seed=13)
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            integ = svc.report().get("integrity", {})
            if integ.get("corruption_detected", 0) >= 1:
                break
            time.sleep(0.05)
    finally:
        svc.stop()
    assert svc._scrub_thread is None and not svc._workers
    integ = svc.report()["integrity"]
    assert integ["scrubs_run"] >= 1
    assert integ["corruption_detected"] >= 1
    assert sum(integ["repairs"].values()) >= 1
    assert svc.sessions[0].verify(repair=False).ok


@pytest.mark.chaos
def test_chaos_plan_soak(tmp_path):
    kw = dict(seed=17, steps=4, streams=2,
              require=("rank", "mirror", "graph", "scatter_drop"), rate=0.0)
    jplan, plan = JChaosPlan(**kw), ChaosPlan(**kw)
    counts = plan.counts()
    assert counts == jplan.counts()
    assert sum(counts.values()) >= 4
    js_, ts_ = _sessions([40, 41], 9, store=tmp_path, durability="wal",
                         checkpoint_interval=2)
    sv = dict(coalesce=False, scrub=False)
    js = JService(js_, serving=JServing(**sv))
    ts = PageRankService(ts_, serving=ServingConfig(**sv))
    cur = {s: js_[s].hg for s in range(2)}
    seed = iter(range(10_000))

    def advance(s):
        dels, ins = random_batch(cur[s], 8 / cur[s].m,
                                 seed=6000 + next(seed))
        js.submit(s, dels, ins)
        ts.submit(s, dels, ins)
        cur[s] = cur[s].apply_batch(dels, ins)

    injected = detected = 0
    for step in range(plan.steps):
        for s in range(2):
            advance(s)
        js.run_until_drained()
        ts.run_until_drained()
        for ev, jev in zip(plan.events_at(step), jplan.events_at(step)):
            assert (ev.kind, ev.stream, ev.seed) == \
                (jev.kind, jev.stream, jev.seed)
            fault = ev.corruption()
            if fault is None:
                continue
            js.sessions[ev.stream].inject_corruption(jev.corruption())
            ts.sessions[ev.stream].inject_corruption(fault)
            injected += 1
            if fault.kind in ("scatter_drop", "scatter_dup"):
                advance(ev.stream)      # the tear needs a consuming update
        js.run_until_drained()
        ts.run_until_drained()
        rj = js.scrub(deep=True, repair=True)
        reports = ts.scrub(deep=True, repair=True)
        _same_scrub(rj, reports)
        detected += sum(1 for r in reports.values() if r.failures)
        assert all(r.ok for r in reports.values())
        assert ts.report()["integrity"] == js.report()["integrity"]
        _same_ranks(js, ts)
    assert injected >= 4
    assert detected == injected, (detected, injected)
    # final state: clean and oracle-tight on every stream
    final = ts.scrub(deep=True, repair=False)
    _same_scrub(js.scrub(deep=True, repair=False), final)
    assert all(r.ok and not r.failures for r in final.values())
    for s in range(2):
        ref = jpr.numpy_reference(cur[s].snapshot(block_size=BS),
                                  iterations=300)
        sess = ts.sessions[s]
        assert float(np.abs(sess.ranks[:sess.n] - ref[:sess.n]).max()) \
            <= 1e-9
    assert ts.report()["integrity"] == js.report()["integrity"]
    for a, b in zip(ts.report()["sessions"], js.report()["sessions"]):
        assert a["integrity"] == b["integrity"]
        assert a["recoveries"] == b["recoveries"]
        assert a["replayed_batches"] == b["replayed_batches"]
    js.stop()
    ts.stop()
