"""The port's sharded topology in process: twins of
``tests/test_api_session.py::TestTopologyConfig`` and ``::TestShardedSession``
held against the JAX package's in-process 1-shard session (counters EQUAL,
f64 ranks within 1e-12), the ``recompute("df")`` replay bit-equal to the
update, forks, an 8-shard port session against the port's blocked oracle at
the reference's 1e-9, the relabeled reads, a service slot, and the
configs and hooks that ROADMAP A 14b brought (their twins are in
``tests/test_torch_shard_faults.py``).
"""
import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.graphs.generators import rmat
from repro_torch.api import registry
from repro_torch.api.config import EngineConfig
from repro_torch.api.service import PageRankService
from repro_torch.api.session import PageRankSession
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.core import distributed as tdist
from repro_torch.core.fault_domain import FaultDomain
from repro_torch.core.graph import HostGraph
from repro_torch.graphs import partition as tpart

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
    """``tests/test_api_session.py::dyn``: rmat(9), its oracle ranks, one
    batch."""
    jg0 = rmat(9, avg_degree=6, seed=5)
    g0 = jg0.snapshot(block_size=64)
    r_prev = np.asarray(jpr.numpy_reference(g0, iterations=300))
    dels, ins = random_batch(jg0, 5e-3, seed=21)
    return jg0, HostGraph(jg0.n, jg0.edges), r_prev, dels, ins


def _pair(dyn, *, r0=True, **kw):
    jg0, hg0, r_prev, _, _ = dyn
    cfg = dict(topology="sharded", n_shards=1, **kw)
    js = JSession.from_graph(jg0, config=JConfig(**cfg),
                             r0=r_prev if r0 else None)
    ts = PageRankSession.from_graph(hg0, config=EngineConfig(**cfg),
                                    r0=r_prev if r0 else None, device="cpu")
    return js, ts


def _same_step(a, b):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert np.abs(b.ranks.numpy() - np.asarray(a.ranks)).max() <= 1e-12


# ---------------------------------------------------------------------------
# TestTopologyConfig twins
# ---------------------------------------------------------------------------

class TestTopologyConfig:
    @pytest.mark.parametrize("kw", [
        dict(topology="nope"),
        dict(topology="sharded", n_shards=0),
        dict(topology="sharded", n_shards=-2),
        dict(partitioner="metis"),
        dict(exchange="ring"),          # rebuild-only, not a session axis
        dict(exchange="nope"),
        dict(n_shards=4),               # needs topology="sharded"
        dict(engine="distributed"),     # topology selects the engine
        dict(topology="sharded", engine="pallas"),
        dict(topology="sharded", driver="push"),
        dict(topology="sharded", device_budget_bytes=1 << 20),
    ])
    def test_bad_topology_combos_rejected(self, kw):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            EngineConfig(**kw)

    def test_shards_are_logical(self):
        # the reference refuses more shards than visible devices; the
        # port's shards share one device, so any count constructs
        import jax
        too_many = len(jax.devices()) + 1
        with pytest.raises(ValueError, match="exceeds"):
            JConfig(topology="sharded", n_shards=too_many)
        assert EngineConfig(topology="sharded",
                            n_shards=too_many).resolved_n_shards == too_many

    def test_sharded_rejects_fault_plans(self):
        from repro_torch.core import faults as flt
        with pytest.raises(ValueError, match="fault simulation"):
            EngineConfig(topology="sharded", n_shards=1,
                         faults=flt.NO_FAULTS)

    def test_sharded_resolves_distributed_engine(self):
        cfg = EngineConfig(topology="sharded", n_shards=1)
        assert cfg.resolved_engine == "distributed"
        assert cfg.resolved_n_shards == 1
        assert EngineConfig(topology="sharded").resolved_n_shards == 1
        assert EngineConfig().resolved_n_shards is None
        assert "distributed" in registry.names()
        assert registry.resolve("distributed").fault_domains == \
            ("shard", "process")

    def test_non_distributed_engines_reject_shard_spec(self, dyn):
        jg0, hg0, r_prev, _, _ = dyn
        g0 = hg0.snapshot(block_size=64, device="cpu")
        eng = registry.resolve("blocked")
        with pytest.raises(ValueError, match="only consumed by "
                                             "engine='distributed'"):
            eng.run(g0, torch.from_numpy(r_prev), g0.vertex_valid,
                    mode="lf", expand=False, alpha=0.85, tau=1e-10,
                    tau_f=None, max_iterations=5, faults=None, tile=512,
                    active_policy="affected",
                    shards=tdist.ShardSpec(n_shards=1))

    def test_distributed_engine_adapter_matches_reference(self, dyn):
        """The snapshot-level adapter over 4 shards: the oracle's ranks."""
        jg0, hg0, r_prev, _, _ = dyn
        g0 = hg0.snapshot(block_size=64, device="cpu")
        eng = registry.resolve("distributed")
        R, st = eng.run(g0, torch.ones(g0.n_pad, dtype=torch.float64) / g0.n,
                        g0.vertex_valid, mode="lf", expand=False, alpha=0.85,
                        tau=1e-10, tau_f=None, max_iterations=500,
                        faults=None, tile=512, active_policy="affected",
                        shards=tdist.ShardSpec(n_shards=4,
                                               partitioner="hash"))
        assert st.converged
        assert np.abs(R.numpy()[:g0.n] - r_prev[:g0.n]).max() < 1e-8
        with pytest.raises(ValueError, match="fault simulation"):
            eng.run(g0, R, g0.vertex_valid, mode="lf", expand=False,
                    alpha=0.85, tau=1e-10, tau_f=None, max_iterations=5,
                    faults=object(), tile=512, active_policy="affected")

    def test_a14b_items_raise_naming_it(self, tmp_path):
        """Since A 14b the three sharded configs construct, as the
        reference's do (the distributed engine hosts the shard domain);
        ``shardings=`` waits for A 15b, its only caller's item."""
        class ShardLike(FaultDomain):
            name = "shard"

        for kw in (dict(fault_domain=ShardLike()),
                   dict(durability="wal"),
                   dict(integrity={"mass_tol": 1e-6})):
            cfg = EngineConfig(topology="sharded", n_shards=2, **kw)
            assert cfg.resolved_engine == "distributed"
        ck = Checkpointer(str(tmp_path))
        ck.save({"w": np.ones(2)}, {"step": np.int32(1)}, 1)
        with pytest.raises(NotImplementedError, match="A 15b"):
            ck.restore(1, {"w": 0}, {"step": 0}, shardings=({}, {}))


# ---------------------------------------------------------------------------
# TestShardedSession twins, against the JAX 1-shard session
# ---------------------------------------------------------------------------

class TestShardedSession:
    def test_static_solve_matches_reference(self, dyn):
        _, hg0, r_prev, _, _ = dyn
        js, ts = _pair(dyn, r0=False, partitioner="bfs_blocks")
        assert np.abs(ts.ranks - js.ranks).max() <= 1e-12
        assert np.abs(ts.ranks[:hg0.n] - r_prev[:hg0.n]).max() < 1e-8
        rep, jrep = ts.report(), js.report()
        assert rep.topology == "sharded" and rep.n_shards == 1
        assert rep.partitioner == "bfs_blocks"
        assert rep.edge_cut == jrep.edge_cut
        assert 0.0 <= rep.edge_cut <= 1.0

    @pytest.mark.parametrize("exchange", ["full", "bf16", "delta"])
    def test_df_stream_matches_jax(self, dyn, exchange):
        js, ts = _pair(dyn, exchange=exchange,
                       **({"dtype": "float32", "tau": 1e-7}
                          if exchange == "bf16" else {}))
        js.warmup()
        ts.warmup()
        cur = dyn[0]
        for i in range(3):
            dels, ins = random_batch(cur, 5e-3, seed=400 + i)
            cur = cur.apply_batch(dels, ins)
            a, b = js.update(dels, ins), ts.update(dels, ins)
            assert b.stats.converged
            if exchange == "bf16":
                assert b.ranks.dtype == torch.float32
                assert np.abs(b.ranks.numpy()
                              - np.asarray(a.ranks)).max() < 1e-4
            else:
                _same_step(a, b)
        rep, jrep = ts.report(), js.report()
        assert rep.retraces_post_warmup == 0
        assert rep.collective_bytes_per_sweep == \
            jrep.collective_bytes_per_sweep
        assert (ts._x_full, ts._x_delta) == (js._x_full, js._x_delta)

    @pytest.mark.parametrize("variant", ["dt", "nd", "static"])
    def test_other_variants_match_jax(self, dyn, variant):
        _, _, _, dels, ins = dyn
        js, ts = _pair(dyn)
        _same_step(js.update(dels, ins, variant=variant),
                   ts.update(dels, ins, variant=variant))

    def test_query_topk_translate_through_relabeling(self, dyn):
        _, _, _, dels, ins = dyn
        js, ts = _pair(dyn, partitioner="hash")
        js.update(dels, ins)
        ts.update(dels, ins)
        full = ts.ranks
        ids = [0, 3, ts.n - 1]
        np.testing.assert_allclose(ts.query(ids), full[ids])
        vals, idx = ts.top_k(4)
        np.testing.assert_allclose(vals, full[idx])
        order = np.argsort(full[:ts.n])[::-1][:4]
        np.testing.assert_allclose(vals, full[order])
        jvals, jidx = js.top_k(4)
        np.testing.assert_array_equal(idx, jidx)
        assert np.abs(vals - jvals).max() <= 1e-12
        assert np.abs(ts.query(ids) - js.query(ids)).max() <= 1e-12

    def test_recompute_variants_and_fork(self, dyn):
        _, _, _, dels, ins = dyn
        js, ts = _pair(dyn)
        with pytest.raises(ValueError, match="no batch"):
            ts.recompute("df")
        ts.warmup()
        out = ts.update(dels, ins)
        replay = ts.recompute("df")
        np.testing.assert_array_equal(out.ranks.numpy(),
                                      replay.ranks.numpy())
        js.update(dels, ins)
        jreplay = js.recompute("df")
        for c in COUNTERS:
            assert getattr(replay.stats, c) == getattr(jreplay.stats, c), c
        for variant in ("dt", "nd", "static"):
            _same_step(js.recompute(variant), ts.recompute(variant))
        twin = ts.fork()
        before = ts.R.clone()
        d2, i2 = random_batch(ts.hg, 5e-3, seed=88)
        twin.update(d2, i2)
        assert ts.report().n_updates == 1     # parent untouched
        assert twin.report().n_updates == 1
        assert twin.report().retraces_post_warmup == 0
        assert torch.equal(ts.R, before)
        assert ts.hg.m != twin.hg.m or not torch.equal(ts.R, twin.R)
        # the parent's own next update still equals the JAX session's
        _same_step(js.update(d2, i2), ts.update(d2, i2))

    def test_integrity_hooks_wait_for_a14b(self, dyn):
        """Since A 14b the hooks give the reference's outcomes: a clean
        ``verify`` runs the 4 rank invariants, a stream-state corruption
        raises at injection, and a ``rank`` flip's frontier rung raises the
        reference's ``ValueError`` (no snapshot to solve on)."""
        js, ts = _pair(dyn)
        for s in (js, ts):
            rep = s.verify()
            assert rep.ok and rep.checks_run == 4
            with pytest.raises(ValueError, match="stream-mode state"):
                s.inject_corruption("tile")
            s.inject_corruption("rank", seed=1)
            with pytest.raises(ValueError, match="needs a GraphSnapshot"):
                s.verify()

    def test_from_snapshot_save_restore_and_close(self, dyn, tmp_path):
        _, hg0, r_prev, dels, ins = dyn
        cfg = EngineConfig(topology="sharded", n_shards=3,
                           partitioner="hash")
        g0 = hg0.snapshot(block_size=64, device="cpu")
        snap = PageRankSession.from_snapshot(g0, config=cfg, r0=r_prev)
        assert snap.hg.m == hg0.m and snap.n == hg0.n
        sess = PageRankSession.from_graph(hg0, config=cfg, r0=r_prev,
                                          device="cpu")
        sess.update(dels, ins)
        snap.update(dels, ins)
        assert np.array_equal(sess.ranks, snap.ranks)
        sess.save(str(tmp_path / "store"))
        back = PageRankSession.restore(str(tmp_path / "store"),
                                       device="cpu")
        np.testing.assert_array_equal(back.ranks, sess.ranks)
        assert back.report().n_shards == 3
        sess.close()
        assert sess.closed and sess.runtime is None


# ---------------------------------------------------------------------------
# 8 logical shards in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", tpart.PARTITIONERS)
def test_eight_shards_match_blocked_oracle(part):
    """``tests/test_sharded_session.py``'s stream, 8 shards, 4 batches:
    within the reference's 1e-9 of the port's blocked oracle, the O(batch)
    edge cut equal to a recount."""
    jg0 = rmat(10, avg_degree=6, seed=3)
    hg0 = HostGraph(jg0.n, jg0.edges)
    r0 = jpr.numpy_reference(jg0.snapshot(block_size=64), iterations=300)
    cfg = EngineConfig(topology="sharded", n_shards=8, partitioner=part)
    sess = PageRankSession.from_graph(hg0, config=cfg, r0=r0, device="cpu")
    oracle = PageRankSession.from_graph(
        hg0, config=EngineConfig(engine="blocked"), r0=r0, device="cpu")
    sess.warmup()
    cur = jg0
    for i in range(4):
        dels, ins = random_batch(cur, 2e-3, seed=900 + i)
        cur = cur.apply_batch(dels, ins)
        res, ores = sess.update(dels, ins), oracle.update(dels, ins)
        assert res.stats.converged and ores.stats.converged
        assert np.abs(sess.ranks[:sess.n]
                      - oracle.ranks[:oracle.n]).max() < 1e-9, (part, i)
        assert res.host_syncs == res.stats.sweeps
    rep = sess.report()
    assert rep.retraces_post_warmup == 0 and rep.n_shards == 8
    expect = tpart.edge_cut(sess.hg, sess._inv // sess.runtime.n_loc)
    assert abs(rep.edge_cut - expect) < 1e-12
    # the host edge log holds the edge set the shard matrices carry
    got = sess.runtime.registered_edges()
    keys = np.sort(got[:, 0] * sess.n + got[:, 1])
    np.testing.assert_array_equal(keys, sess._hg_rel._keys)


def test_runtime_shrink_and_capacity_growth():
    """``shrink`` re-partitions onto the survivors from the host edge log
    (same fixed point); a batch past a shard matrix's packed-index capacity
    grows it, and the grown runtime reaches the fixed point of one built
    afresh from its edge set."""
    jg0 = rmat(9, avg_degree=6, seed=5)
    hg0 = HostGraph(jg0.n, jg0.edges)
    rt = tdist.DistRuntime(hg0, tdist.ShardMesh.on("cpu", 4))
    R, st = rt.drive(torch.full((rt.n_pad,), 1.0 / rt.n,
                                dtype=torch.float64), rt.valid,
                     expand=False)
    small = rt.shrink(2)
    assert small.n_dev == 3 and small.owned_range(2) == (342, 512)
    R2, st2 = small.drive(R, small.valid, expand=False)
    assert st.converged and st2.converged
    assert np.abs(R2.numpy()[:rt.n] - R.numpy()[:rt.n]).max() < 1e-9
    cap0 = rt.dg.mats[0].index.entry_capacity
    s, d = np.meshgrid(np.arange(rt.n), np.arange(rt.n_loc), indexing="ij")
    cand = np.stack([s.ravel(), d.ravel()], 1)
    cand = cand[cand[:, 0] != cand[:, 1]]
    new = cand[~hg0.has_edges(cand)]             # all into shard 0
    assert len(new) > cap0
    rt.apply_batch(np.zeros((0, 2), np.int64), new)
    assert rt.dg.mats[0].index.entry_capacity > cap0
    grown = hg0.apply_batch(np.zeros((0, 2), np.int64), new)
    np.testing.assert_array_equal(rt.registered_edges(), grown.edges)
    fresh = tdist.DistRuntime(grown, tdist.ShardMesh.on("cpu", 4))
    R3, st3 = rt.drive(R, rt.valid, expand=False)
    R4, st4 = fresh.drive(R, fresh.valid, expand=False)
    assert st3.converged and st4.converged
    assert np.abs(R3.numpy()[:rt.n] - R4.numpy()[:rt.n]).max() < 1e-12
    with pytest.raises(ValueError, match="cannot shrink"):
        tdist.DistRuntime(hg0, tdist.ShardMesh.on("cpu", 1)).shrink(0)


@pytest.mark.parametrize("fold_every", [1, 3, 0])
def test_runtime_edge_log_equals_sequential_batches(fold_every):
    """The host edge log read after every batch, every third, or only at
    the end (deletions, re-insertions of deleted edges) equals the batches applied one by one to the host graph, and a
    fork's log is independent of its parent's."""
    jg = rmat(9, avg_degree=6, seed=8)
    hg = HostGraph(jg.n, jg.edges)
    rt = tdist.DistRuntime(hg, tdist.ShardMesh.on("cpu", 4))
    rng = np.random.default_rng(17)
    dropped = np.zeros((0, 2), np.int64)
    for i in range(6):
        e = hg.edges
        dels = e[rng.choice(len(e), 40, replace=False)]
        back = dropped[:len(dropped) // 2]
        ins = np.concatenate([back, rng.integers(0, hg.n, (40, 2))])
        ins = ins[(ins[:, 0] != ins[:, 1]) & ~hg.has_edges(ins)]
        ins = np.unique(ins, axis=0)
        rt.apply_batch(dels, ins)
        hg = hg.apply_batch(dels, ins)
        dropped = np.concatenate([dropped[len(dropped) // 2:], dels])
        if fold_every and i % fold_every == 0:
            np.testing.assert_array_equal(rt.registered_edges(), hg.edges)
        if i == 2:
            twin, hg_twin = rt.fork(), hg
    np.testing.assert_array_equal(rt.registered_edges(), hg.edges)
    np.testing.assert_array_equal(twin.registered_edges(), hg_twin.edges)


def test_service_slot_reads_translate(dyn):
    """A service slot holding a sharded session serves degraded reads from
    its read view, translated as the session's own reads are."""
    _, hg0, r_prev, dels, ins = dyn
    sess = PageRankSession.from_graph(
        hg0, config=EngineConfig(topology="sharded", n_shards=4,
                                 partitioner="hash"),
        r0=r_prev, device="cpu")
    svc = PageRankService([sess], warmup=False, device="cpu")
    svc.submit(0, dels, ins)
    svc.run_until_drained()
    ids = [0, 7, sess.n - 1]
    np.testing.assert_array_equal(svc.query(0, ids).values, sess.query(ids))
    got = svc.top_k(0, 5)
    vals, idx = sess.top_k(5)
    np.testing.assert_array_equal(got.values, vals)
    np.testing.assert_array_equal(got.vertices, idx)


@pytest.mark.parametrize("exchange", ["full", "delta"])
def test_drive_suspends_and_resumes_bit_for_bit(exchange):
    """``drive(collect_state=True)`` hands back the affected and
    still-unconverged masks; resuming from them with ``rc0=`` ends where one
    uninterrupted drive ends, bit for bit, in as many sweeps."""
    jg0 = rmat(9, avg_degree=6, seed=5)
    hg0 = HostGraph(jg0.n, jg0.edges)
    mesh = tdist.ShardMesh.on("cpu", 4)
    one = tdist.DistRuntime(hg0, mesh, exchange=exchange)
    two = tdist.DistRuntime(hg0, mesh, exchange=exchange)
    R0 = torch.full((one.n_pad,), 1.0 / one.n, dtype=torch.float64)
    seed = one.mask_from_indices(np.arange(0, one.n, 7))
    R, st = one.drive(R0, seed, expand=True)
    Ra, sa, (aff, rc) = two.drive(R0, seed, expand=True, max_sweeps=5,
                                  collect_state=True)
    assert sa.sweeps == 5 and not sa.converged
    assert aff.shape == rc.shape == (two.n_pad,) and bool(rc.any())
    Rb, sb = two.drive(Ra, aff, expand=True, rc0=rc)
    assert sb.converged and sa.sweeps + sb.sweeps == st.sweeps
    assert torch.equal(Rb, R)
    assert sa.edges_processed + sb.edges_processed == st.edges_processed
