"""The port's snapshot mode, engine registry, config rules, dense oracle
engine, legacy ``*_pagerank`` functions and invariant predicates, against
the JAX package.

The same inputs (numpy, from a seed) go through ``repro`` (JAX on the CPU;
the pallas engine with ``backend="xla"``) and ``repro_torch``
(``device="cpu"``, the plain kernels).  Counters (sweeps, iterations,
blocks, edges, converged) must be EQUAL, f64 ranks within 1e-12 of the
reference's, the dense oracle and ``reference_pagerank`` within 1e-12 of
the reference's, and every converged solve within 1e-9 of the numpy
oracle.  The legacy functions must equal the session call they shim onto
bit for bit, in the port as in the reference.
"""
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.api import registry as jregistry
from repro.core import delta as jdelta
from repro.core import frontier as jfr
from repro.core import pagerank as jpr
from repro.graphs import generators as jgen
from repro_torch.api import registry
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.core import frontier as tfr
from repro_torch.core import pagerank as tpr
from repro_torch.core import properties as prop
from repro_torch.core.blocked import SweepStats
from repro_torch.core.delta import (coalesce_batches, pure_deletion_batch,
                                    random_batch, validate_edge_batch)
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.graphs import generators as tgen

TAU = 1e-10
COUNTERS = ("sweeps", "iterations", "blocks_processed", "edges_processed",
            "converged")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(jhg, dels, ins, block):
    """(JAX, port) snapshots of G^{t-1} and G^t, the packed batches and the
    pre-batch numpy oracle, from one JAX host graph and one batch."""
    thg = THostGraph(jhg.n, jhg.edges)
    jg0, jg1 = (h.snapshot(block_size=block)
                for h in (jhg, jhg.apply_batch(dels, ins)))
    tg0, tg1 = (h.snapshot(block_size=block, device="cpu")
                for h in (thg, thg.apply_batch(dels, ins)))
    r_prev = tpr.numpy_reference(tg0, iterations=300)
    return dict(jhg=jhg, thg=thg, jg0=jg0, jg1=jg1, tg0=tg0, tg1=tg1,
                jb=jfr.batch_to_device(jg1, dels, ins),
                tb=tfr.batch_to_device(tg1, dels, ins),
                r_prev=r_prev, dels=dels, ins=ins,
                ref1=tpr.numpy_reference(tg1, iterations=300))


@pytest.fixture(scope="module")
def dyn():
    """tests/test_api_session.py's fixture: rmat(9), B = 64."""
    hg0 = jgen.rmat(9, avg_degree=6, seed=5)
    dels, ins = jdelta.random_batch(hg0, 5e-3, seed=21)
    return _both(hg0, dels, ins, 64)


@pytest.fixture(scope="module")
def dyn_setup():
    """tests/test_core_pagerank.py's fixture: rmat(11), B = 128."""
    hg0 = jgen.rmat(11, avg_degree=8, seed=3)
    dels, ins = jdelta.random_batch(hg0, 1e-3, seed=11)
    return _both(hg0, dels, ins, 128)


def _legacy(mod, d, variant, side, **kw):
    """One legacy variant call of ``mod`` (repro's or the port's) on the
    fixture's inputs."""
    g0, g1, b = ((d["jg0"], d["jg1"], d["jb"]) if side == "j"
                 else (d["tg0"], d["tg1"], d["tb"]))
    r = jnp.asarray(d["r_prev"]) if side == "j" else d["r_prev"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if variant == "static":
            return mod.static_pagerank(g1, **kw)
        if variant == "nd":
            return mod.nd_pagerank(g1, r, **kw)
        if variant == "dt":
            return mod.dt_pagerank(g0, g1, b, r, **kw)
        return mod.df_pagerank(g0, g1, b, r, **kw)


def _same(a, b, tol=1e-12):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert np.abs(np.asarray(b.ranks) - np.asarray(a.ranks)).max() <= tol


# ---------------------------------------------------------------------------
# registry (twin of tests/test_api_session.py::TestRegistry)
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_unknown_engine_error_lists_registered(self):
        with pytest.raises(ValueError, match="dense.*pallas"):
            registry.resolve("not-an-engine")
        # the walk engine registers since A 13, the distributed engine since
        # A 14a
        assert registry.names() == ("blocked", "dense", "distributed", "pallas",
                                    "walk")
        assert registry.default_engine() == "pallas"
        assert registry.resolve(None).name == "pallas"

    def test_custom_engine_registers_and_resolves(self):
        class EchoEngine:
            name = "echo-test"

            def run(self, g, R0, affected0, **kw):
                return R0, SweepStats(converged=True)

        registry.register(EchoEngine())
        try:
            assert "echo-test" in registry.names()
            assert registry.resolve("echo-test").name == "echo-test"
            assert isinstance(registry.resolve("echo-test"), registry.Engine)
            with pytest.raises(ValueError, match="already registered"):
                registry.register(EchoEngine())
        finally:
            registry._REGISTRY.pop("echo-test", None)

    def test_invalid_adapters_rejected(self):
        class NoName:
            def run(self):
                pass

        class NoRun:
            name = "no-run"

        with pytest.raises(ValueError, match="name"):
            registry.register(NoName())
        with pytest.raises(ValueError, match="callable .run"):
            registry.register(NoRun())

    def test_non_pallas_engines_reject_tile_operands(self, dyn):
        with pytest.raises(ValueError, match="only consumed by "
                                             "engine='pallas'"):
            _legacy(tpr, dyn, "nd", "t", engine="dense", mode="bb",
                    pallas_mat=object())
        eng = registry.resolve("dense")
        g = dyn["tg0"]
        with pytest.raises(ValueError, match="only consumed by "
                                             "engine='distributed'"):
            eng.run(g, tpr.initial_ranks(g), g.vertex_valid, mode="bb",
                    expand=False, alpha=0.85, tau=TAU, tau_f=None,
                    max_iterations=5, faults=None, tile=512,
                    active_policy="affected", shards=object())

    def test_capabilities_and_fault_domains(self):
        for name in ("blocked", "dense", "pallas"):
            eng = registry.resolve(name)
            assert registry.supports_of(eng) == frozenset()
            # the reference's declarations: since A 11 the pallas engine
            # also hosts the corruption domain
            assert registry.fault_domains_of(eng) == \
                jregistry.fault_domains_of(jregistry.resolve(name))
            assert registry.fault_domains_of(eng)[:2] == ("thread",
                                                          "process")
            registry.reject_personalization(eng, {"walk_seed": None})
            with pytest.raises(registry.CapabilityError, match="ppr"):
                registry.reject_personalization(eng, {"walk_seed": 3})
        assert issubclass(registry.CapabilityError, ValueError)


class TestEngineConfig:
    def test_env_override_validated_eagerly(self, monkeypatch):
        monkeypatch.setenv("REPRO_ENGINE", "bogus")
        with pytest.raises(ValueError, match="REPRO_ENGINE.*registered"):
            TConfig()
        monkeypatch.setenv("REPRO_ENGINE", "dense")
        assert TConfig(mode="bb").resolved_engine == "dense"
        assert tpr.default_engine() == "dense"
        # the dense engine's LF mode (the default mode) runs the blocked
        # engine
        assert TConfig().resolved_engine == "dense"
        assert TConfig().mode == "lf"

    @pytest.mark.parametrize("kw,err,match", [
        # a budget with the dense engine gets the reference's ValueError;
        # a tiered push stream constructs since A 10b (err None)
        ({"engine": "pallas", "driver": "push",
          "device_budget_bytes": 1 << 20}, None, None),
        ({"engine": "blocked", "mode": "lf", "driver": "push"}, ValueError,
         "pallas"),
        ({"engine": "dense", "mode": "bb", "driver": "push"}, ValueError,
         "pallas"),
        ({"engine": "not-an-engine"}, ValueError, "registered engines"),
        ({"engine": "dense", "mode": "lf", "device_budget_bytes": 1 << 20},
         ValueError, "streaming pallas"),
    ])
    def test_engine_rules(self, kw, err, match):
        if err is None:
            assert TConfig(**kw).device_budget_bytes == 1 << 20
            return
        with pytest.raises(err, match=match):
            TConfig(**kw)

    def test_dense_bb_constructs(self):
        cfg = TConfig(engine="dense", mode="bb")
        assert cfg.resolved_engine == "dense"
        assert TConfig().resolved_engine == "pallas"


# ---------------------------------------------------------------------------
# legacy functions: warning + bit-for-bit session parity (twin of
# tests/test_api_session.py::TestDeprecationShims, on the pallas engine)
# ---------------------------------------------------------------------------

class TestDeprecationShims:
    ENGINE = "pallas"

    def _cfg(self, mode):
        return TConfig(mode=mode, engine=self.ENGINE, block_size=64)

    def test_static(self, dyn):
        with pytest.warns(DeprecationWarning, match="static_pagerank"):
            res = tpr.static_pagerank(dyn["tg0"], mode="bb",
                                      engine=self.ENGINE)
        sess = TSession.from_snapshot(dyn["tg0"], config=self._cfg("bb"))
        out = sess.recompute("static")
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    def test_nd(self, dyn):
        with pytest.warns(DeprecationWarning, match="nd_pagerank"):
            res = tpr.nd_pagerank(dyn["tg0"], dyn["r_prev"], mode="lf",
                                  engine=self.ENGINE)
        sess = TSession.from_snapshot(dyn["tg0"], config=self._cfg("lf"),
                                      r0=dyn["r_prev"])
        out = sess.recompute("nd")
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    @pytest.mark.parametrize("variant", ["dt", "df"])
    @pytest.mark.parametrize("mode", ["stream", "snapshot"])
    def test_dt_df(self, dyn, variant, mode):
        """``test_dt`` / ``test_df``: the legacy call equals the session's
        update bit for bit, from a stream session (``from_graph``) and a
        snapshot session (``from_snapshot`` with ``hg=``)."""
        fn = tpr.dt_pagerank if variant == "dt" else tpr.df_pagerank
        with pytest.warns(DeprecationWarning, match=f"{variant}_pagerank"):
            res = fn(dyn["tg0"], dyn["tg1"], dyn["tb"], dyn["r_prev"],
                     mode="lf", engine=self.ENGINE)
        if mode == "stream":
            sess = TSession.from_graph(dyn["thg"], config=self._cfg("lf"),
                                       r0=dyn["r_prev"], device="cpu")
        else:
            sess = TSession.from_snapshot(dyn["tg0"], hg=dyn["thg"],
                                          config=self._cfg("lf"),
                                          r0=dyn["r_prev"])
        assert sess._stream == (mode == "stream")
        out = sess.update(dyn["dels"], dyn["ins"], variant=variant)
        assert torch.equal(res.ranks, out.ranks)
        assert res.stats.sweeps == out.stats.sweeps

    @pytest.mark.parametrize("mode", ["stream", "snapshot"])
    def test_df_recompute_replays_last_batch(self, dyn, mode):
        """recompute('df') after update == the update itself (same marking,
        same pre-batch ranks)."""
        cfg = self._cfg("lf")
        sess = (TSession.from_graph(dyn["thg"], config=cfg,
                                    r0=dyn["r_prev"], device="cpu")
                if mode == "stream" else
                TSession.from_snapshot(dyn["tg0"], hg=dyn["thg"], config=cfg,
                                       r0=dyn["r_prev"]))
        out = sess.update(dyn["dels"], dyn["ins"], variant="df")
        replay = sess.recompute("df")
        assert torch.equal(out.ranks, replay.ranks)

    def test_recompute_dt_df_require_a_batch(self, dyn):
        sess = TSession.from_snapshot(dyn["tg0"], hg=dyn["thg"],
                                      config=TConfig(engine="dense",
                                                     mode="bb"),
                                      r0=dyn["r_prev"])
        with pytest.raises(ValueError, match="no batch"):
            sess.recompute("df")
        # warmup's internal empty batch must not count as "the last update"
        stream = TSession.from_graph(dyn["thg"], config=TConfig(
            engine="pallas", block_size=64), r0=dyn["r_prev"], device="cpu")
        stream.warmup()
        with pytest.raises(ValueError, match="no batch"):
            stream.recompute("dt")

    def test_legacy_keyword_rules(self, dyn):
        with pytest.raises(TypeError, match="taux.*valid keys"):
            _legacy(tpr, dyn, "nd", "t", taux=1.0)
        with pytest.raises(ValueError, match="backend"):
            _legacy(tpr, dyn, "nd", "t", pallas_backend="xla")
        # the dense engine's default mode, LF, is the blocked engine
        dense = _legacy(tpr, dyn, "df", "t", engine="dense")
        blocked = _legacy(tpr, dyn, "df", "t", engine="blocked")
        assert dense.converged and torch.equal(dense.ranks, blocked.ranks)


# ---------------------------------------------------------------------------
# the variant matrix against the reference and the oracle (twins of
# tests/test_core_pagerank.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["nd", "dt", "df"])
@pytest.mark.parametrize("mode,engine", [("bb", "pallas"), ("lf", "pallas"),
                                         ("bb", "dense")])
def test_dynamic_variants_match_oracle(dyn_setup, variant, mode, engine):
    d = dyn_setup
    res = _legacy(tpr, d, variant, "t", mode=mode, engine=engine, tau=TAU)
    jkw = {"pallas_backend": "xla"} if engine == "pallas" else {}
    ref = _legacy(jpr, d, variant, "j", mode=mode, engine=engine, tau=TAU,
                  **jkw)
    assert res.converged
    _same(ref, res)
    assert np.abs(res.ranks.numpy()[:d["tg1"].n]
                  - d["ref1"][:d["tg1"].n]).max() <= 1e-9


@pytest.mark.parametrize("engine,mode", [("pallas", "lf"), ("pallas", "bb"),
                                         ("dense", "bb")])
def test_snapshot_session_tracks_jax(dyn, engine, mode):
    """from_snapshot(hg=) sessions take the four variants in turn, then the
    df and dt replays, step by step against the JAX snapshot session."""
    jkw = {"backend": "xla"} if engine == "pallas" else {}
    js = JSession.from_snapshot(dyn["jg0"], hg=dyn["jhg"], config=JConfig(
        engine=engine, mode=mode, tau=TAU, **jkw))
    ts = TSession.from_snapshot(dyn["tg0"], hg=dyn["thg"], config=TConfig(
        engine=engine, mode=mode, tau=TAU))
    assert not ts._stream and ts.device == torch.device("cpu")
    assert np.abs(ts.ranks - np.asarray(js.R)).max() <= 1e-12
    for i, variant in enumerate(("df", "dt", "nd", "static")):
        dels, ins = jdelta.random_batch(js.hg, 5e-3, seed=60 + i,
                                        deletions_frac=0.2)
        _same(js.update(dels, ins, variant=variant),
              ts.update(dels, ins, variant=variant))
        np.testing.assert_array_equal(ts.hg.edges, js.hg.edges)
    for variant in ("df", "dt", "nd", "static"):
        _same(js.recompute(variant), ts.recompute(variant))
    rep = ts.report()
    assert rep.engine == engine and rep.n_updates == 4
    assert set(rep.device_bytes) == {"ranks", "graph_snapshot"}
    ts.warmup()                 # a snapshot session is born warm
    ref = tpr.numpy_reference(ts.g, iterations=300)
    assert np.abs(ts.ranks[:ts.n] - ref[:ts.n]).max() <= 1e-9


def test_dense_session_from_graph_and_bare_snapshot(dyn):
    """from_graph with the dense engine is snapshot mode; a bare snapshot
    session serves reads but cannot update; a push snapshot session is
    refused."""
    ts = TSession.from_graph(dyn["thg"], config=TConfig(
        engine="dense", mode="bb", block_size=64), device="cpu")
    assert not ts._stream and ts.g is not None
    js = JSession.from_graph(dyn["jhg"], config=JConfig(
        engine="dense", mode="bb", block_size=64))
    assert np.abs(ts.ranks - np.asarray(js.R)).max() <= 1e-12
    np.testing.assert_array_equal(ts.top_k(5)[1], js.top_k(5)[1])
    bare = TSession.from_snapshot(dyn["tg0"], config=TConfig(
        engine="dense", mode="bb"), r0=dyn["r_prev"])
    assert bare.query([0, 1]).shape == (2,)
    with pytest.raises(ValueError, match="from_graph"):
        bare.update(dyn["dels"], dyn["ins"])
    with pytest.raises(ValueError, match="forward-push stream"):
        TSession.from_snapshot(dyn["tg0"], config=TConfig(driver="push"))
    bare.close()
    assert bare.closed and bare.g is None


def test_stability_delete_then_reinsert():
    """Paper §5.2.3: delete a batch, update, re-insert, update — the final
    ranks match the original ones."""
    hg0 = tgen.rmat(10, avg_degree=8, seed=5)
    g0 = hg0.snapshot(block_size=128, device="cpu")
    r0 = torch.as_tensor(tpr.numpy_reference(g0, iterations=300))
    dels = pure_deletion_batch(hg0, 1e-3, seed=2)
    z = np.zeros((0, 2))
    hg1 = hg0.apply_batch(dels, z)
    g1 = hg1.snapshot(block_size=128, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r1 = tpr.df_pagerank(g0, g1, tfr.batch_to_device(g1, dels, z), r0,
                             mode="lf").ranks
        g2 = hg1.apply_batch(z, dels).snapshot(block_size=128, device="cpu")
        r2 = tpr.df_pagerank(g1, g2, tfr.batch_to_device(g2, z, dels), r1,
                             mode="lf").ranks
    assert tpr.linf(r2[:g0.n], r0[:g0.n]) <= 1e-9


def test_initial_affected_is_out_neighbors(dyn_setup):
    d = dyn_setup
    aff = tfr.initial_affected(d["tg0"], d["tg1"], d["tb"]).numpy()
    expect = np.zeros(d["tg1"].n_pad, dtype=bool)
    srcs = set(int(u) for u, _ in d["tb"].numpy() if u < d["tg1"].n)
    for g in (d["tg0"], d["tg1"]):
        src, dst = g.in_edges_host()
        expect[dst[np.isin(src, list(srcs))]] = True
    np.testing.assert_array_equal(aff, expect)


def test_dt_superset_of_df_initial_and_helping(dyn_setup):
    """test_dt_superset_of_df_initial and
    test_helping_equals_faultfree_marking."""
    d = dyn_setup
    df0 = tfr.initial_affected(d["tg0"], d["tg1"], d["tb"])
    dt0 = tfr.dt_affected(d["tg0"], d["tg1"], d["tb"])
    assert bool((dt0 | ~df0).all())
    fp = np.zeros(d["tb"].shape[0], dtype=bool)
    fp[::3] = True   # the first pass processed only a third of the updates
    aff, C, rounds = tfr.initial_affected_with_helping(
        d["tg0"], d["tg1"], d["tb"], fp)
    assert torch.equal(aff, df0) and bool(C.all()) and rounds >= 1


def test_reference_pagerank_jax_vs_numpy():
    jhg = jgen.grid_road(48, seed=0)
    g = THostGraph(jhg.n, jhg.edges).snapshot(block_size=64, device="cpu")
    r = tpr.reference_pagerank(g, iterations=200)
    assert tpr.linf(r, tpr.numpy_reference(g, iterations=200)) < 1e-12
    jr = jpr.reference_pagerank(jhg.snapshot(block_size=64), iterations=200)
    assert tpr.linf(r, np.array(jr)) <= 1e-12


def test_dense_oracle_and_ppr_equal_jax(dyn):
    """dense_jacobi (uniform and personalized teleport, with and without
    expansion), restart_vector and ppr_numpy_reference against the
    reference's."""
    tg, jg = dyn["tg1"], dyn["jg1"]
    seeds = [1, 5, 200]
    tp, jp = tpr.restart_vector(tg, seeds), jpr.restart_vector(jg, seeds)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tpr.ppr_numpy_reference(tg, seeds),
                               jpr.ppr_numpy_reference(jg, seeds), rtol=0,
                               atol=1e-15)
    rng = np.random.default_rng(4)
    aff = rng.random(tg.n_pad) < 0.2
    for pers in (None, tp):
        for expand in (False, True):
            R0 = tpr.initial_ranks(tg)
            r, it, conv = tpr.dense_jacobi(
                tg, R0, torch.tensor(aff), expand=expand, tau=TAU,
                personalization=pers)
            jr, jit, jconv = jpr.dense_jacobi(
                jg, jnp.asarray(R0.numpy()), jnp.asarray(aff), expand=expand,
                tau=TAU, personalization=None if pers is None
                else jnp.asarray(pers))
            assert (it, conv) == (jit, jconv)
            assert np.abs(r.numpy() - np.asarray(jr)).max() <= 1e-12
    r, _, conv = tpr.dense_jacobi(tg, tpr.initial_ranks(tg), tg.vertex_valid,
                                  expand=False, tau=TAU, personalization=tp)
    assert conv and np.abs(r.numpy() - tpr.ppr_numpy_reference(
        tg, seeds)).max() <= 1e-9
    for bad in ([], [tg.n]):
        with pytest.raises(ValueError):
            tpr.restart_vector(tg, bad)


def test_dt_marks_superset_and_matches_reference():
    """Twin of tests/test_dt_and_elastic.py's first test."""
    hg = tgen.rmat(11, 8, seed=0)
    cap = 1024 * ((hg.m * 3 + 2 * hg.n) // 1024 + 3)
    dels, ins = random_batch(hg, 1e-3, seed=1)
    hg2 = hg.apply_batch(dels, ins)
    g1 = hg.snapshot(edge_capacity=cap, device="cpu")
    g2 = hg2.snapshot(edge_capacity=cap, device="cpu")
    batch = tfr.batch_to_device(g2, dels, ins)
    r_prev = tpr.reference_pagerank(g1, iterations=250)
    ref = tpr.reference_pagerank(g2, iterations=250)
    df0 = tfr.initial_affected(g1, g2, batch)
    dt0 = tfr.dt_affected(g1, g2, batch)
    assert bool((~df0 | dt0).all()) and int(dt0.sum()) >= int(df0.sum())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        dt = tpr.dt_pagerank(g1, g2, batch, r_prev, mode="lf")
        df = tpr.df_pagerank(g1, g2, batch, r_prev, mode="lf")
    assert dt.stats.converged and df.stats.converged
    assert tpr.linf(dt.ranks, ref[:dt.ranks.shape[0]]) < 1e-9
    assert tpr.linf(df.ranks, ref[:df.ranks.shape[0]]) < 1e-9


# ---------------------------------------------------------------------------
# invariant predicates (twins of tests/test_properties.py, as seeded loops)
# ---------------------------------------------------------------------------

def _graph(n: int, m: int, seed: int) -> THostGraph:
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], 1)
    return THostGraph(n, e)


def _cases(k, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(k):
        n = int(rng.integers(16, 200))
        yield (n, int(rng.integers(n, 4 * n)), int(rng.integers(0, 2 ** 16)),
               float(rng.choice([1e-2, 0.05, 0.2])))


def _snap_batch(n, m, seed, frac, salt):
    hg = _graph(n, m, seed)
    dels, ins = random_batch(hg, frac, seed=seed + salt)
    g1 = hg.snapshot(device="cpu")
    g2 = hg.apply_batch(dels, ins).snapshot(device="cpu")
    return hg, g1, g2, tfr.batch_to_device(g2, dels, ins)


def test_rank_conservation_and_reference_match():
    for n, _, seed, _ in _cases(8, seed=1):
        g = _graph(n, 3 * n, seed).snapshot(device="cpu")
        r = tpr.reference_pagerank(g, iterations=150)
        assert prop.rank_conservation_error(g, r) < 1e-6
        ref = tpr.numpy_reference(g, iterations=150)
        assert prop.ranks_match_reference(r, ref, tol=1e-12)
        assert not prop.ranks_match_reference(r + 1e-6, ref, tol=1e-9)


def test_marking_idempotent_and_helping_equals_full_marking():
    rng = np.random.default_rng(7)
    for n, m, seed, frac in _cases(10, seed=2):
        _, g1, g2, batch = _snap_batch(n, m, seed, frac, 1)
        assert prop.marking_idempotent(g1, g2, batch)
        first = rng.random(batch.shape[0]) < rng.random()
        full = tfr.initial_affected(g1, g2, batch)
        helped, checked, _ = tfr.initial_affected_with_helping(
            g1, g2, batch, first)
        assert torch.equal(full, helped) and bool(checked.all())


def test_frontier_monotone_and_fault_schedule_sound():
    rng = np.random.default_rng(3)
    for n, m, seed, _ in _cases(8, seed=3):
        g = _graph(n, m, seed).snapshot(device="cpu")
        flags = torch.as_tensor(rng.random(g.n_pad) < 0.1)
        grown, _ = tfr.expand_frontier(g, flags, flags,
                                       torch.zeros_like(flags))
        assert prop.frontier_monotone(flags, grown)
        assert not prop.frontier_monotone(grown, flags) or torch.equal(
            grown, flags)
    for _ in range(10):
        n_threads = int(rng.integers(1, 65))
        plan = FaultPlan(n_threads=n_threads,
                         n_crashed=min(int(rng.integers(0, 64)),
                                       n_threads - 1),
                         delay_prob=float(rng.uniform(0, 0.9)), delay_ms=10,
                         seed=int(rng.integers(0, 2 ** 16)))
        assert prop.fault_schedule_sound(plan)


def test_delete_insert_roundtrip():
    for n, m, seed, frac in _cases(10, seed=4):
        hg = _graph(n, m, seed)
        rng = np.random.default_rng(seed)
        k = max(1, int(frac * hg.m))
        batch = hg.edges[rng.choice(hg.m, size=min(k, hg.m), replace=False)]
        assert prop.delete_insert_roundtrip(hg, batch)


def test_coalesce_properties():
    """Sequential equivalence, delete-then-reinsert and last-write-wins of
    ``coalesce_batches``."""
    rng = np.random.default_rng(11)
    z = np.zeros((0, 2), np.int64)
    for _ in range(15):
        n = int(rng.integers(8, 64))
        seed = int(rng.integers(0, 2 ** 16))

        def pairs(k):
            if k == 0:
                return z
            src = rng.integers(0, n, k)
            dst = (src + 1 + rng.integers(0, n - 1, k)) % n
            return np.stack([src, dst], 1).astype(np.int64)

        batches = [(pairs(int(rng.integers(0, 7))),
                    pairs(int(rng.integers(0, 7))))
                   for _ in range(int(rng.integers(1, 6)))]
        hg = _graph(n, 2 * n, seed)
        seq = hg
        for d, i in batches:
            seq = seq.apply_batch(d, i)
        dels, ins = coalesce_batches(batches, n)
        validate_edge_batch(dels, ins, n)
        np.testing.assert_array_equal(hg.apply_batch(dels, ins).edges,
                                      seq.edges)
        edge = hg.edges[rng.integers(hg.m)][None, :]
        dels, ins = coalesce_batches([(edge, z), (z, edge)], n)
        assert len(dels) == 0 and np.array_equal(ins, edge)
        dels, ins = coalesce_batches([(z, edge), (edge, z)], n)
        assert len(ins) == 0 and np.array_equal(dels, edge)
        ops = rng.random(int(rng.integers(1, 7))) < 0.5
        dels, ins = coalesce_batches(
            [(z, edge) if o else (edge, z) for o in ops], n)
        assert (len(ins), len(dels)) == ((1, 0) if ops[-1] else (0, 1))
