"""The port's shard fault domain, its durable, ``integrity=`` and serviced
sharded sessions, in process against the JAX package's 1-shard session.

Twins of ``tests/test_fault_domains.py``'s shard tests (``:110-200``): the
domain's topology rule, the thread domain refused on a sharded topology,
``inject_shard_fault`` off sharded and out of range, the construction-time
range check, a permanent loss of the last shard degrading to a stall, the
schedule cloned per session, ``fork`` emptying it; then faulted streams
over a grid of crash points (counters EQUAL, f64 ranks within 1e-12, the
recovery events equal but for ``wall_time_s``), the seven corruption kinds
with and without ``defer`` on an ``integrity=`` sharded session (the
reference's outcome, an exception type or the report's fields, is the
port's), durable sharded sessions restored onto other shard counts and
onto one device (a store written by either package restored by the other),
a durable sharded slot's watchdog failover and the service's sharded rows.
The 8-shard helping and rescale scenarios are in
``tests/test_torch_distributed.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankService as JService
from repro.api import PageRankSession as JSession
from repro.api import ServingConfig as JServing
from repro.core import fault_domain as jfd
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.core.faults import FaultPlan as JPlan
from repro.graphs.generators import rmat
from repro_torch.api import (EngineConfig, IntegrityConfig, PageRankService,
                             PageRankSession, ServingConfig, ShardFault,
                             ShardFaultDomain, ThreadFaultDomain)
from repro_torch.core import fault_domain as tfd
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph

CPU = "cpu"
KINDS = ("rank", "tile", "slot", "mirror", "scatter_drop", "scatter_dup",
         "graph")
COUNTERS = ("sweeps", "iterations", "edges_processed", "converged")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dyn():
    """rmat(9) (``tests/test_api_session.py::dyn``'s graph), its oracle
    ranks and a stream of 4 batches."""
    jg0 = rmat(9, avg_degree=6, seed=5)
    r0 = np.asarray(jpr.numpy_reference(jg0.snapshot(block_size=64),
                                        iterations=300))
    batches, cur = [], jg0
    for i in range(4):
        d, a = random_batch(cur, 5e-3, seed=40 + i)
        batches.append((d, a))
        cur = cur.apply_batch(d, a)
    return jg0, HostGraph(jg0.n, jg0.edges), r0, batches


def _pair(dyn, *, jdomain=None, tdomain=None, jstore=None, tstore=None,
          **kw):
    """The JAX 1-shard session and the port's, opened from the oracle."""
    jg0, hg0, r0, _ = dyn
    cfg = dict(topology="sharded", n_shards=1, **kw)
    js = JSession.from_graph(jg0, config=JConfig(fault_domain=jdomain, **cfg),
                             r0=r0, store_dir=jstore)
    ts = PageRankSession.from_graph(
        hg0, config=EngineConfig(fault_domain=tdomain, **cfg), r0=r0,
        device=CPU, store_dir=tstore)
    return js, ts


def _same_step(a, b):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert b.driver_retraces == 0
    assert np.abs(b.ranks.numpy() - np.asarray(a.ranks)).max() <= 1e-12


def _events(rep) -> list:
    return [{k: v for k, v in e.items() if k != "wall_time_s"}
            for e in rep.recovery_events]


def _same_report(js, ts):
    rj, rt = js.report(), ts.report()
    assert _events(rt) == _events(rj)
    for key in ("recoveries", "n_shards", "replayed_batches",
                "total_sweeps", "total_edges_processed", "topology",
                "partitioner"):
        assert getattr(rt, key) == getattr(rj, key), key
    assert abs(rt.edge_cut - rj.edge_cut) <= 1e-12
    assert np.abs(ts.ranks - js.ranks).max() <= 1e-12


# ---------------------------------------------------------------------------
# the domain and its config rules
# ---------------------------------------------------------------------------

class TestShardDomainConfig:
    def test_shard_domain_needs_sharded_topology(self):
        for C, D in ((JConfig, jfd.ShardFaultDomain),
                     (EngineConfig, ShardFaultDomain)):
            with pytest.raises(ValueError, match="sharded"):
                C(fault_domain=D())
        assert EngineConfig(topology="sharded", n_shards=2,
                            fault_domain=ShardFaultDomain()).fault_domain

    def test_thread_domain_rejected_on_sharded_topology(self):
        for C, D, P in ((JConfig, jfd.ThreadFaultDomain, JPlan),
                        (EngineConfig, ThreadFaultDomain, FaultPlan)):
            with pytest.raises(ValueError, match="ShardFaultDomain"):
                C(topology="sharded", n_shards=1,
                  fault_domain=D(P(n_threads=4)))

    @pytest.mark.parametrize("kw", [
        dict(engine="pallas"), dict(engine="blocked"), dict(engine="dense"),
        dict(topology="sharded", n_shards=1)])
    def test_shard_like_domain_gets_the_reference_outcome(self, kw):
        """A ``FaultDomain`` subclass named "shard" (no topology rule of its
        own): the engine's declared domains decide, in both packages."""
        outcomes = []
        for base in (jfd.FaultDomain, tfd.FaultDomain):
            ShardLike = type("ShardLike", (base,), {"name": "shard"})
            C = JConfig if base is jfd.FaultDomain else EngineConfig
            try:
                C(fault_domain=ShardLike(), **kw)
                outcomes.append("ok")
            except ValueError as e:
                assert "does not host the 'shard' fault domain" in str(e)
                outcomes.append("ValueError")
        assert outcomes[0] == outcomes[1]
        assert outcomes[0] == ("ok" if "topology" in kw else "ValueError")

    def test_schedule_api_matches_reference(self):
        doms = (jfd.ShardFaultDomain([jfd.ShardFault(2)]),
                ShardFaultDomain([ShardFault(2)]))
        for d in doms:
            d.inject(5, at_sweep=3, permanent=False)
            twin = d.clone()
            assert d.pending == 2 and twin.pending == 2
            assert d.pop_pending().shard == 2
            assert d.pending == 1 and twin.pending == 2
        for a, b in zip(doms[0].pending_faults, doms[1].pending_faults):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert doms[1].pop_pending() == ShardFault(5, 3, False)
        assert doms[1].pop_pending() is None
        with pytest.raises(dataclasses.FrozenInstanceError):
            ShardFault(0).shard = 1


# ---------------------------------------------------------------------------
# the session's shard domain, against the JAX 1-shard session
# ---------------------------------------------------------------------------

class TestShardFaultSession:
    def test_inject_shard_fault_requires_sharded(self, dyn):
        _, hg0, r0, _ = dyn
        sess = PageRankSession.from_graph(
            hg0, config=EngineConfig(block_size=64), r0=r0, device=CPU)
        with pytest.raises(ValueError, match="sharded"):
            sess.inject_shard_fault(0)

    def test_shard_fault_range_validated_at_injection(self, dyn):
        js, ts = _pair(dyn)
        for s in (js, ts):
            with pytest.raises(ValueError, match="out of range"):
                s.inject_shard_fault(5)
            with pytest.raises(ValueError, match="out of range"):
                s.inject_shard_fault(-1)
        # a config-carried schedule is checked at construction
        with pytest.raises(ValueError, match="outside the 1-shard"):
            _pair(dyn, jdomain=jfd.ShardFaultDomain([jfd.ShardFault(7)]))
        with pytest.raises(ValueError, match="outside the 1-shard"):
            _pair(dyn, tdomain=ShardFaultDomain([ShardFault(7)]))

    def test_permanent_fault_on_last_shard_degrades_to_transient(self, dyn):
        batches = dyn[3]
        js, ts = _pair(dyn)
        for s in (js, ts):
            s.inject_shard_fault(0, permanent=True)
        _same_step(js.update(*batches[0]), ts.update(*batches[0]))
        rep = ts.report()
        assert rep.recoveries == 1 and rep.n_shards == 1
        assert rep.recovery_events[0]["permanent"] is False
        _same_report(js, ts)

    def test_config_shared_schedule_is_cloned_per_session(self, dyn):
        batches = dyn[3]
        jd = jfd.ShardFaultDomain([jfd.ShardFault(0, permanent=False)])
        td = ShardFaultDomain([ShardFault(0, permanent=False)])
        pairs = [_pair(dyn, jdomain=jd, tdomain=td) for _ in range(2)]
        for js, ts in pairs:
            _same_step(js.update(*batches[0]), ts.update(*batches[0]))
            assert ts.report().recoveries == 1    # not stolen by the other
            _same_report(js, ts)
        assert td.pending == 1                    # the config's stays whole

    def test_fork_gets_an_empty_domain(self, dyn):
        batches = dyn[3]
        js, ts = _pair(dyn)
        for s in (js, ts):
            s.inject_shard_fault(0, at_sweep=2, permanent=False)
        jf, tf = js.fork(), ts.fork()
        assert tf._shard_faults.pending == jf._shard_faults.pending == 0
        _same_step(jf.update(*batches[0]), tf.update(*batches[0]))
        assert tf.report().recoveries == jf.report().recoveries == 0
        _same_step(js.update(*batches[0]), ts.update(*batches[0]))
        _same_report(js, ts)
        assert ts.report().recoveries == 1

    @pytest.mark.parametrize("at_sweep,permanent,variant", [
        (1, False, "df"), (2, True, "df"), (7, False, "df"),
        (10_000, False, "df"), (3, False, "nd"), (2, False, "static")])
    def test_faulted_stream_matches_reference(self, dyn, at_sweep, permanent,
                                              variant):
        """One stall or (degraded) loss mid-stream: the update's counters,
        the recovery event and every later update equal the reference's;
        a crash scheduled past convergence records nothing."""
        batches = dyn[3]
        js, ts = _pair(dyn)
        _same_step(js.update(*batches[0]), ts.update(*batches[0]))
        for s in (js, ts):
            s.inject_shard_fault(0, at_sweep=at_sweep, permanent=permanent)
        rj = js.update(*batches[1], variant=variant)
        rt = ts.update(*batches[1], variant=variant)
        _same_step(rj, rt)
        # one read a sweep, plus the help count when a recovery ran
        rec = ts.report().recoveries
        assert rt.host_syncs == rt.stats.sweeps + rec
        assert rec == (0 if at_sweep == 10_000 else 1)
        for b in batches[2:]:
            _same_step(js.update(*b), ts.update(*b))
        _same_report(js, ts)
        assert ts.report().retraces_post_warmup == 0

    def test_stale_fault_is_dropped(self, dyn):
        """A fault whose shard no longer exists (the race with an earlier
        shrink) is dropped at consumption, never raised mid-update."""
        batches = dyn[3]
        js, ts = _pair(dyn)
        js._shard_faults._pending.append(jfd.ShardFault(7))
        ts._shard_faults._pending.append(ShardFault(7))
        _same_step(js.update(*batches[0]), ts.update(*batches[0]))
        assert ts.report().recoveries == 0
        assert ts._shard_faults.pending == 0
        _same_report(js, ts)


# ---------------------------------------------------------------------------
# integrity= on a sharded session
# ---------------------------------------------------------------------------

def _integrity_outcome(sess, kind, defer, batch):
    """Where the chain inject → (update) → verify raised and what, or the
    verify report's fields."""
    stage = "inject"
    try:
        sess.inject_corruption(kind, seed=3, defer=defer)
        if defer:
            stage = "update"
            sess.update(*batch)
        stage = "verify"
        rep = sess.verify()
    except ValueError as e:
        return (stage, "ValueError", str(e))
    return ("ok", rep.ok, [f["check"] for f in rep.failures], rep.repairs,
            rep.checks_run)


class TestShardedIntegrity:
    def test_verify_is_clean_with_the_rank_invariants(self, dyn):
        batches = dyn[3]
        js, ts = _pair(dyn, integrity=IntegrityConfig().to_dict())
        for s in (js, ts):
            s.update(*batches[0])
        rj, rt = js.verify(), ts.verify()
        assert rt.ok and rj.ok
        assert rt.checks_run == rj.checks_run == 4
        assert rt.failures == rj.failures == [] and rt.repairs == []
        assert ts.report().integrity["checks_run"] == \
            js.report().integrity["checks_run"] == 4

    @pytest.mark.parametrize("defer", [False, True])
    @pytest.mark.parametrize("kind", KINDS)
    def test_corruption_outcome_matches_reference(self, dyn, kind, defer):
        """The reference's outcome on a sharded session is the port's: the
        stream-state kinds raise, the scatter kinds change nothing, and a
        ``rank`` flip reaches the frontier rung, whose snapshot solve
        raises (a defect of both packages, ROADMAP watch list 1)."""
        batches = dyn[3]
        js, ts = _pair(dyn, integrity=IntegrityConfig().to_dict())
        for s in (js, ts):
            s.update(*batches[0])
        oj = _integrity_outcome(js, kind, defer, batches[1])
        ot = _integrity_outcome(ts, kind, defer, batches[1])
        assert ot == oj
        if kind == "rank":
            assert ot[:2] == ("verify", "ValueError")
            assert "needs a GraphSnapshot" in ot[2]
        elif kind.startswith("scatter"):
            assert ot == ("ok", True, [], [], 4)
        else:
            assert ot[1] == "ValueError" and "stream-mode" in ot[2]
        assert ts._corruption_detected == js._corruption_detected

    @pytest.mark.parametrize("repair", [False, True])
    @pytest.mark.parametrize("fault", [None, False, True],
                             ids=["clean", "stall", "last_shard_loss"])
    def test_verify_after_update_matches_reference(self, dyn, fault, repair):
        """verify → update (clean, or with a stall or a permanent loss of
        the one shard, which degrades to a stall) → verify: a sharded drive
        sets no drift baseline, so the second verify finds the update as
        ``rank_drift`` and, repairing, its frontier rung raises, in both
        packages (ROADMAP watch list 1).  The 8-shard loss, which also
        changes the padding, is in ``tests/test_torch_distributed.py``."""
        batches = dyn[3]
        js, ts = _pair(dyn, integrity=IntegrityConfig().to_dict())
        outcomes = []
        for s in (js, ts):
            first = s.verify()
            assert first.ok and first.checks_run == 4
            if fault is not None:
                s.inject_shard_fault(0, at_sweep=2, permanent=fault)
            s.update(*batches[0])
            outcomes.append(_verify_outcome(s, repair))
        oj, ot = outcomes
        assert ot[:-1] == oj[:-1]
        if repair:
            assert ot[:2] == ("ValueError", "snapshot-level solve needs a "
                              "GraphSnapshot (stream-mode sessions use "
                              "update/recompute)")
        else:
            assert ot[:4] == (False, ["rank_drift"], [], 4)
            assert abs(ot[-1] - oj[-1]) <= 1e-12
        _same_report(js, ts)


def _verify_outcome(sess, repair):
    """What ``verify(repair=...)`` raised (its type and message), or its
    report's ``ok``, failed checks, repairs, ``checks_run`` and drift."""
    try:
        rep = sess.verify(repair=repair)
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return (type(e).__name__, str(e), None)
    return (rep.ok, [f["check"] for f in rep.failures], rep.repairs,
            rep.checks_run, rep.drift)


# ---------------------------------------------------------------------------
# durable sharded sessions and the elastic restore
# ---------------------------------------------------------------------------

def _durable_history(dyn, tmp_path):
    """The same durable 1-shard history in each package (checkpoint every
    3 batches, 4 updates: a checkpoint at 3, one WAL record after it)."""
    jst, tst = str(tmp_path / "j"), str(tmp_path / "t")
    js, ts = _pair(dyn, durability="wal", checkpoint_interval=3,
                   jstore=jst, tstore=tst)
    for b in dyn[3]:
        _same_step(js.update(*b), ts.update(*b))
    return js, ts, jst, tst


class TestDurableSharded:
    @pytest.mark.parametrize("target", [
        dict(topology="sharded", n_shards=1),
        dict(topology="sharded", n_shards=3),
        dict(topology="sharded", n_shards=2, partitioner="hash"),
        dict(engine="pallas"), dict(engine="blocked")],
        ids=["1shard", "3shards", "2shards_hash", "pallas", "blocked"])
    def test_restore_onto_other_shard_counts(self, dyn, tmp_path, target):
        """Each package's store restores in the port onto ``target`` with
        one batch replayed: within the reference's elastic gate (1e-9) of
        the live session, the two stores' restores within 1e-12 of each
        other and, where the JAX package runs ``target`` in process (one
        shard, or one device), of its own restore."""
        js, ts, jst, tst = _durable_history(dyn, tmp_path)
        live = js.ranks
        del js, ts                           # crash-stop: no close()
        cfg = EngineConfig(block_size=64, **target)
        got = []
        for store in (tst, jst):
            rest = PageRankSession.restore(store, config=cfg, device=CPU)
            rep = rest.report()
            assert rep.replayed_batches == 1
            assert rep.recovery_events[-1]["domain"] == "process"
            assert rest._batch_index == 4
            assert rep.n_shards == target.get("n_shards")
            got.append(rest.ranks[:rest.n])
            assert np.abs(got[-1] - live[:rest.n]).max() <= 1e-9
            rest.close()
        assert np.abs(got[0] - got[1]).max() <= 1e-12
        if target.get("n_shards", 1) == 1:
            jrest = JSession.restore(jst, config=JConfig(block_size=64,
                                                         **target))
            assert jrest.report().replayed_batches == 1
            assert np.abs(got[0] - jrest.ranks[:jrest.n]).max() <= 1e-12
        if target == dict(topology="sharded", n_shards=1):
            # the port's own store onto its own shard count: bit for bit
            own = PageRankSession.restore(tst, device=CPU)
            assert own.store is not None
            assert own.report().replayed_batches == 1
            np.testing.assert_array_equal(own.ranks[:own.n], got[0])
            assert np.abs(got[0] - live[:own.n]).max() <= 1e-12
            own.close()

    def test_port_store_restores_in_the_reference(self, dyn, tmp_path):
        js, ts, jst, tst = _durable_history(dyn, tmp_path)
        live = ts.ranks
        rj = JSession.restore(tst, config=JConfig(topology="sharded",
                                                  n_shards=1))
        assert rj.report().replayed_batches == 1
        assert np.abs(rj.ranks[:rj.n] - live[:rj.n]).max() <= 1e-12
        # the stores hold the same checkpoint index and WAL tail
        assert ts.store.latest_checkpoint_index == \
            js.store.latest_checkpoint_index == 3

    def test_durable_sharded_save_and_fork(self, dyn, tmp_path):
        js, ts, jst, tst = _durable_history(dyn, tmp_path)
        twin = ts.fork()
        assert twin.store is None and twin._shard_faults.pending == 0
        path = ts.save()
        assert ts.store.latest_checkpoint_index == 4 and path
        rest = PageRankSession.restore(tst, device=CPU)
        assert rest.report().replayed_batches == 0
        np.testing.assert_array_equal(rest.ranks, ts.ranks)
        assert ts.device_footprint == twin.device_footprint == (0,)
        ts.close()
        assert ts.device_footprint == ()


# ---------------------------------------------------------------------------
# the service: sharded rows, a durable sharded slot's failover
# ---------------------------------------------------------------------------

def test_service_sharded_rows_match_reference(dyn):
    """Twin of ``tests/test_sharded_session.py:100-120`` on one shard: the
    sharded slot's row carries topology, n_shards, partitioner and edge
    cut, the blocked slot's does not; the keys equal the reference's."""
    jg0, hg0, r0, batches = dyn
    svcs = []
    for S, Svc, C, g, dev in (
            (JSession, JService, JConfig, jg0, {}),
            (PageRankSession, PageRankService, EngineConfig, hg0,
             {"device": CPU})):
        a = S.from_graph(g, config=C(topology="sharded", n_shards=1,
                                     partitioner="hash"), r0=r0, **dev)
        b = S.from_graph(g, config=C(engine="blocked"), r0=r0, **dev)
        svc = Svc([a, b], warmup=False)
        for i in (0, 1):
            svc.submit(i, *batches[0])
        svc.run_until_drained()
        svcs.append(svc)
    js, ts = svcs
    rj, rt = js.report(), ts.report()
    for a, b in zip(rt["sessions"], rj["sessions"]):
        # the port counts kernel builds, not the reference's jit buckets
        assert set(a) == set(b) - {"bucket_retraces_post_warmup"}
    row = rt["sessions"][0]
    assert (row["topology"], row["n_shards"], row["partitioner"]) == \
        ("sharded", 1, "hash")
    assert abs(row["edge_cut"] - rj["sessions"][0]["edge_cut"]) <= 1e-12
    assert "topology" not in rt["sessions"][1]
    # logical shards: the sharded slot sits on the one device it runs on
    assert ts.placements() == {0: (0,), 1: (0,)}
    assert np.abs(ts.sessions[0].ranks - ts.sessions[1].ranks).max() < 1e-9


def test_durable_sharded_slot_fails_over_from_its_store(dyn, tmp_path):
    """A durable sharded slot dies on its second dispatch; the watchdog
    respawns it through ``restore`` and drains its queue to the respawn,
    as the reference's does."""
    jg0, hg0, r0, batches = dyn
    kw = dict(topology="sharded", n_shards=1, durability="wal",
              checkpoint_interval=2)
    svcs = []
    for name, S, Svc, C, V, g, dev in (
            ("j", JSession, JService, JConfig, JServing, jg0, {}),
            ("t", PageRankSession, PageRankService, EngineConfig,
             ServingConfig, hg0, {"device": CPU})):
        sess = S.from_graph(g, config=C(**kw), r0=r0,
                            store_dir=str(tmp_path / name), **dev)
        svc = Svc([sess], warmup=False, serving=V(coalesce=False))
        svc.inject_session_fault(0, after_dispatches=1, kind="dead")
        for d, a in batches[:3]:
            svc.submit(0, d, a)
            svc.step()
        svc.run_until_drained()
        svcs.append(svc)
    js, ts = svcs
    ev, jev = ts.report()["watchdog"], js.report()["watchdog"]
    assert len(ev) == len(jev) == 1
    for key in ("kind", "domain", "drained_requests", "replayed_batches",
                "batch_index", "stream"):
        assert ev[0][key] == jev[0][key], key
    row, jrow = ts.report()["sessions"][0], js.report()["sessions"][0]
    for key in ("recoveries", "replayed_batches", "durability", "topology",
                "n_shards", "n_updates", "sweeps_history"):
        assert row[key] == jrow[key], key
    sess = ts.sessions[0]
    assert sess._sharded and sess._batch_index == 3
    assert np.abs(sess.ranks - js.sessions[0].ranks).max() <= 1e-12
