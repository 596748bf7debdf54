"""The port's stream session against the JAX package's ``PageRankSession``.

Both sessions open on the same host graph (the generators give identical
edge sets per seed) and receive the same batches (numpy, from a seed).  The
JAX session runs ``engine="pallas", backend="xla"``; the port runs on the
CPU (``device="cpu"``, its plain kernels).  After every batch the ranks
agree within L∞ ≤ 1e-9 in f64 (same arithmetic, different summation order:
~1e-18 observed) and the sweep, block and edge counters are EQUAL.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.api.session import _seed_affected as j_seed_affected
from repro.core import delta as jdelta
from repro.core import frontier as jfr
from repro.core.fault_domain import FaultDomain as JFaultDomain
from repro.graphs import generators as jgen
from repro_torch.api import session as tsession
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.convert import block_sparse_from_numpy, session_from_numpy
from repro_torch.core import frontier as tfr
from repro_torch.core.fault_domain import FaultDomain
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.pagerank import numpy_reference

# f32 products stay IEEE on the card (no TF32), as in the JAX tests
torch.backends.cuda.matmul.allow_tf32 = False

B = 32
COUNTERS = ("sweeps", "iterations", "blocks_processed", "edges_processed",
            "converged")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _open(jg, **cfg):
    js = JSession.from_graph(jg, config=JConfig(
        engine="pallas", backend="xla", block_size=B, tau=1e-10, **cfg))
    ts = TSession.from_graph(THostGraph(jg.n, jg.edges), config=TConfig(
        block_size=B, tau=1e-10, **cfg), device="cpu")
    return js, ts


def _assert_step(a, b, js, ts):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert np.abs(ts.R.numpy() - np.asarray(js.R)).max() <= 1e-9


@pytest.mark.parametrize("graph", ["grid_road", "rmat"])
def test_df_stream_tracks_jax_batch_by_batch(graph):
    """A 20-batch DF stream (the paper's 80/20 insert/delete mix), then the
    independent oracle on the final graph at the stream test's bound."""
    jg = (jgen.grid_road(16, seed=7) if graph == "grid_road"
          else jgen.rmat(8, avg_degree=4, seed=7))
    js, ts = _open(jg)
    assert np.abs(ts.R.numpy() - np.asarray(js.R)).max() <= 1e-9
    js.warmup()
    ts.warmup()
    for i in range(20):
        dels, ins = jdelta.random_batch(js.hg, 5e-3, seed=100 + i,
                                        deletions_frac=0.2)
        _assert_step(js.update(dels, ins), ts.update(dels, ins), js, ts)
        np.testing.assert_array_equal(ts.hg.edges, js.hg.edges)
    rep = ts.report()
    assert rep.n_updates == 20 and rep.batches_converged == 20
    assert rep.retraces_post_warmup == 0
    assert rep.sweeps_history == js.report().sweeps_history
    assert all(s >= 1 for s in rep.host_syncs_history)
    ref = numpy_reference(ts.hg.snapshot(block_size=B, device="cpu"),
                          iterations=300)
    assert np.abs(ts.ranks[:ts.n] - ref[:ts.n]).max() < 1e-9


@pytest.mark.parametrize("variant", ["nd", "static"])
def test_nd_and_static_track_jax(variant):
    js, ts = _open(jgen.grid_road(20, seed=3))
    dels, ins = jdelta.random_batch(js.hg, 0.01, seed=4, deletions_frac=0.2)
    _assert_step(js.update(dels, ins, variant=variant),
                 ts.update(dels, ins, variant=variant), js, ts)


def test_fault_plan_session_tracks_jax():
    plan = dict(n_threads=4, delay_prob=0.2, delay_ms=1.0, seed=2)
    from repro.core.faults import FaultPlan as JFaultPlan
    jg = jgen.grid_road(20, seed=5)
    js = JSession.from_graph(jg, config=JConfig(
        engine="pallas", backend="xla", block_size=B, tau=1e-10,
        faults=JFaultPlan(**plan)))
    ts = TSession.from_graph(THostGraph(jg.n, jg.edges), config=TConfig(
        block_size=B, tau=1e-10, faults=FaultPlan(**plan)), device="cpu")
    dels, ins = jdelta.random_batch(js.hg, 0.01, seed=6, deletions_frac=0.2)
    a, b = js.update(dels, ins), ts.update(dels, ins)
    _assert_step(a, b, js, ts)
    assert b.stats.sim_time_ms == pytest.approx(a.stats.sim_time_ms,
                                                rel=1e-6)


def test_query_and_top_k_equal_jax():
    js, ts = _open(jgen.rmat(9, avg_degree=4, seed=11))
    ids = np.array([0, 5, 17, 300, 511])
    np.testing.assert_allclose(ts.query(ids), js.query(ids), rtol=0,
                               atol=1e-15)
    vj, ij = js.top_k(12)
    vt, it = ts.top_k(12)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-15)
    assert ts.query(7).shape == (1,)
    for bad in (-1, ts.n, 2.5):
        with pytest.raises(ValueError):
            ts.query([bad])
    with pytest.raises(ValueError):
        ts.top_k(0)


def test_seed_affected_equals_jax():
    """The DF seed over two separately built pull matrices (no in-place
    sharing) equals the JAX session's seed."""
    jg = jgen.grid_road(16, seed=2)
    dels, ins = jdelta.random_batch(jg, 0.03, seed=3, deletions_frac=0.3)
    jg2 = jg.apply_batch(dels, ins)
    from repro.core.pallas_engine import build_pull_matrix
    from repro.kernels.block_spmv.ops import block_adjacency
    g1, g2 = jg.snapshot(block_size=B), jg2.snapshot(block_size=B)
    m1 = build_pull_matrix(g1, padded=True)
    m2 = build_pull_matrix(g2, padded=True)
    bmat = np.asarray(block_adjacency(m2))
    batch = jfr.pack_batch(g1.n_pad, dels, ins)
    hj = j_seed_affected(m1, m2, jnp.asarray(bmat), batch, g1.vertex_valid,
                         block_size=B, interpret=True, backend="xla")

    def port(m):
        return block_sparse_from_numpy(
            np.asarray(m.tiles), np.asarray(m.tile_cols),
            np.asarray(m.tile_idx), m.n_rows, m.n_cols, m.block,
            device="cpu")

    ht = tsession._seed_affected(
        port(m1), port(m2), torch.tensor(bmat),
        tfr.pack_batch(g1.n_pad, dels, ins, device="cpu"),
        torch.tensor(np.asarray(g1.vertex_valid)), block_size=B)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert ht.any()


def test_session_from_numpy_round_trips():
    """A port session started from a JAX session's graph and ranks serves
    exactly those ranks and then tracks the JAX session."""
    js = JSession.from_graph(jgen.grid_road(16, seed=8), config=JConfig(
        engine="pallas", backend="xla", block_size=B, tau=1e-10))
    ts = session_from_numpy(js.hg.n, js.hg.edges, np.asarray(js.R),
                            TConfig(block_size=B, tau=1e-10), device="cpu")
    np.testing.assert_array_equal(ts.ranks, np.asarray(js.R))
    np.testing.assert_array_equal(ts.hg.edges, js.hg.edges)
    dels, ins = jdelta.random_batch(js.hg, 0.02, seed=9, deletions_frac=0.2)
    _assert_step(js.update(dels, ins), ts.update(dels, ins), js, ts)
    ts.close()
    assert ts.closed
    with pytest.raises(ValueError, match="closed"):
        ts.top_k(1)


class _ProcessDomain(FaultDomain):
    """A fault domain other than the thread domain that is not the port's
    ProcessFaultDomain; since A 11 it gets the reference's outcome (the
    engine declares "process": it constructs)."""
    name = "process"


class _JProcessDomain(JFaultDomain):
    """The reference package's twin of :class:`_ProcessDomain`."""
    name = "process"


def _walk_config_serves(kw: dict) -> None:
    """A configuration of the walk axis opens and serves as the
    reference's does: the walk fields on the default engine get the
    capability refusal in both packages; with ``engine="walk"`` both open a
    session whose update and ``ppr_query`` agree bit for bit."""
    from repro.api import CapabilityError as JCapabilityError
    from repro_torch.api import CapabilityError
    if "engine" not in kw:
        with pytest.raises(CapabilityError, match="'ppr' capability"):
            TConfig(**kw)
        with pytest.raises(JCapabilityError, match="'ppr' capability"):
            JConfig(**kw)
    kw = {**kw, "engine": "walk"}
    jg = jgen.rmat(6, avg_degree=4, seed=3)
    tg = THostGraph(jg.n, jg.edges)
    js = JSession.from_graph(jg, config=JConfig(**kw))
    ts = TSession.from_graph(tg, config=TConfig(**kw), device="cpu")
    dels, ins = jdelta.random_batch(jg, 0.05, seed=5)
    a, b = js.update(dels, ins), ts.update(dels, ins)
    assert (a.regenerated_walks, a.touched_walks) == (b.regenerated_walks,
                                                      b.touched_walks)
    assert np.array_equal(np.asarray(a.ranks), b.ranks.numpy())
    jv, ji = js.ppr_query([0, 5], 8)
    tv, ti = ts.ppr_query([0, 5], 8)
    assert np.array_equal(jv, tv) and np.array_equal(ji, ti)
    js.close()
    ts.close()


@pytest.mark.parametrize("kw,item", [
    # a stream with a budget runs since A 10a (pull) and A 10b (push): the
    # cases with item None construct
    ({"driver": "push", "device_budget_bytes": 1 << 20}, None),
    # the sharded topology runs since A 14a: it constructs and resolves the
    # distributed engine, as the reference's does (id kept from when it
    # raised naming A 14)
    pytest.param({"topology": "sharded"}, "sharded", id="kw1-A 14"),
    # the walk engine and its fields run since A 13: the cases with item
    # "walk" open a walk session that serves (ids kept from when they
    # raised naming A 13)
    pytest.param({"walks_per_vertex": 4}, "walk", id="kw2-A 13"),
    pytest.param({"walk_length": 8}, "walk", id="kw3-A 13"),
    pytest.param({"walk_seed": 1}, "walk", id="kw4-A 13"),
    # durability="wal" runs since A 9 and tiers under either driver since
    # A 10b
    ({"durability": "wal", "driver": "push", "device_budget_bytes": 1 << 20},
     None),
    # integrity= and any fault domain an engine declares run since A 11
    ({"integrity": {"mass_tol": 1e-6}}, None),
    ({"fault_domain": _ProcessDomain()}, None),
    # the blocked engine and the dense engine's LF mode run since A 7; the
    # later axes still refuse on them
    # a budget on the blocked engine gets the reference's ValueError
    # (test_budget_config_rules); naming the pallas engine outright
    # constructs a tiered push stream
    ({"engine": "pallas", "driver": "push", "device_budget_bytes": 1 << 20},
     None),
    ({"engine": "dense", "fault_domain": _ProcessDomain()}, None),
    pytest.param({"engine": "walk"}, "walk", id="kw10-A 13"),
    # engine="distributed" without topology="sharded" gets the reference's
    # ValueError since A 14a (id kept from when it raised naming A 14)
    pytest.param({"engine": "distributed"}, "refused", id="kw11-A 14"),
])
def test_out_of_slice_config_raises(kw, item):
    if item == "walk":
        _walk_config_serves(kw)
        return
    if item == "sharded":
        cfg, jcfg = TConfig(**kw), JConfig(**kw)
        assert cfg.resolved_engine == jcfg.resolved_engine == "distributed"
        assert cfg.resolved_n_shards == 1
        return
    if item == "refused":
        with pytest.raises(ValueError, match="requires topology"):
            JConfig(**kw)
        with pytest.raises(ValueError, match="requires topology"):
            TConfig(**kw)
        return
    if item is None:
        # ported: the config constructs, as the reference's does (whose
        # default engine off the TPU is "blocked": name the pallas engine)
        cfg = TConfig(**kw)
        jkw = {k: _JProcessDomain() if isinstance(v, _ProcessDomain) else v
               for k, v in kw.items()}
        jcfg = JConfig(**{"engine": "pallas", **jkw})
        for f in ("device_budget_bytes", "driver", "durability"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert (cfg.integrity is None) == (jcfg.integrity is None)
        if cfg.integrity is not None:
            assert cfg.integrity.to_dict() == jcfg.integrity.to_dict()
        assert (cfg.fault_domain is None) == (jcfg.fault_domain is None)
        return
    with pytest.raises(NotImplementedError, match=item):
        TConfig(**kw)


@pytest.mark.parametrize("kw,match", [
    ({"engine": "blocked", "device_budget_bytes": 1 << 20},
     "streaming pallas"),
    ({"engine": "dense", "mode": "bb", "device_budget_bytes": 1 << 20},
     "streaming pallas"),
    ({"topology": "sharded", "device_budget_bytes": 1 << 20},
     "cannot compose"),
    ({"device_budget_bytes": 0}, "positive integer"),
    ({"device_budget_bytes": True}, "positive integer"),
])
def test_budget_config_rules(kw, match):
    """The reference's ValueErrors for a budget outside a pallas stream,
    for the JAX config and the port's alike."""
    with pytest.raises(ValueError, match=match):
        JConfig(**kw)
    with pytest.raises(ValueError, match=match):
        TConfig(**kw)
    assert TConfig(device_budget_bytes=1 << 20).device_budget_bytes \
        == 1 << 20


def test_config_validation_and_backend_rule():
    for bad in ({"backend": "pallas"}, {"backend": "xla"}):
        with pytest.raises(ValueError, match="device='cpu'"):
            TConfig(**bad)
    for bad in ({"mode": "x"}, {"alpha": 1.0}, {"tau": 0},
                {"active_policy": "x"}, {"block_size": 0},
                {"n_shards": 2}, {"engine": "nope"}, {"dtype": "int8"}):
        with pytest.raises(ValueError):
            TConfig(**bad)
    with pytest.raises(TypeError, match="unknown"):
        TConfig.from_kwargs(taux=1.0)
    assert TConfig().resolved_dtype() == torch.float64
    assert TConfig(tau=1e-8).resolved_tau_f(expand=True) == pytest.approx(
        1e-11)
    assert set(TConfig.valid_keys()) == set(JConfig.valid_keys())


def test_dt_variant_raises_not_implemented():
    """A pull ``update(variant="dt")`` raised ``NotImplementedError`` until
    the port had the DT marking, and the dense engine's LF mode until the
    blocked engine (A 7).  Both run now (their parity with the JAX package
    is in tests/test_torch_variants.py and tests/test_torch_blocked.py)."""
    hg = THostGraph(16, np.array([[0, 1], [1, 2]]))
    for cfg in (TConfig(block_size=8), TConfig(block_size=8, engine="dense",
                                               mode="lf")):
        ts = TSession.from_graph(hg, config=cfg, device="cpu")
        res = ts.update(np.zeros((0, 2)), np.array([[0, 5]]), variant="dt")
        assert res.converged and ts.hg.has_edges(np.array([[0, 5]])).all()
    assert ts.engine_name == "dense" and not ts._stream


def test_default_device_raises_without_cuda(monkeypatch):
    """With no CUDA device the default ``device="cuda"`` raises: the port
    never carries on on the CPU unless asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hg = THostGraph(16, np.array([[0, 1], [1, 2]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSession.from_graph(hg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hg.snapshot(block_size=8)
