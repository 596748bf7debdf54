"""The port's walk engine (``repro_torch.core.walk_engine``) against the JAX
package's (``repro.core.walk_engine``), bit for bit.

Both packages build their walk store from the same numpy edges and take
the same batches (``repro.core.delta.random_batch`` on the reference's host
graph).  Every draw of a walk is the reference's threefry
(``tests/test_torch_walk_rng.py``), so the walk buffers, visit counts,
adjacency slabs and degrees are array-equal, every ``WalkUpdateStats``
field is equal (across a slab widening too), and ``pagerank()``, ``ppr()``
and ``ppr_top_k`` are equal to the last bit, ties lower id first.  The
comparisons with the oracles keep the reference's own bounds (0.35, 0.8,
0.5).

Twins of ``tests/test_walk_engine.py``'s config and store tests (the dense
personalization and ``powerlaw`` tests have theirs in
``tests/test_torch_snapshot.py``).  The twins of the walk properties W1 and
W2 of ``tests/test_properties.py`` are in
``tests/test_torch_walk_properties.py``, the session, durable and service
twins in ``tests/test_torch_walk_session.py``.
"""
import numpy as np
import pytest
import torch

from repro.api import CapabilityError as JCapabilityError
from repro.api import EngineConfig as JConfig
from repro.api import registry as jregistry
from repro.core import pagerank as jpr
from repro.core.delta import random_batch
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.graph import HostGraph as JHostGraph
from repro.core.incremental import effective_batch
from repro.core.integrity import IntegrityConfig as JIntegrityConfig
from repro.core.walk_engine import WalkState as JWalkState
from repro.graphs.generators import powerlaw as jpowerlaw
from repro_torch.api import CapabilityError, EngineConfig, registry
from repro_torch.core import pagerank as tpr
from repro_torch.core import walk_engine as twe
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph, initial_ranks
from repro_torch.core.integrity import IntegrityConfig
from repro_torch.core.walk_engine import WalkState
from repro_torch.graphs.generators import powerlaw

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


def _same_store(jw: JWalkState, tw: WalkState) -> None:
    for name in ("walks", "counts", "adj", "deg"):
        assert np.array_equal(np.asarray(getattr(jw, name)),
                              getattr(tw, name).numpy()), name


def _same_floats(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _stores(jh, th, **kw):
    return JWalkState(jh, **kw), WalkState(th, device=CPU, **kw)


def _stats(stats) -> dict:
    """Every ``WalkUpdateStats`` field, by name (either package's)."""
    return {f: getattr(stats, f) for f in (
        "touched_vertices", "touched_walk_mass", "regenerated_walks",
        "total_walks", "steps", "batch_bucket", "adj_cap", "new_bucket")}


# ---------------------------------------------------------------------------
# WalkState parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,L,seed", [(6, 16, 9), (1, 2, 0), (3, 48, 7),
                                      (4, 12, 2 ** 32 + 5)])
def test_walk_state_construction_equals_reference(R, L, seed):
    jh, th = _pair(seed=R + L)
    jw, tw = _stores(jh, th, R=R, L=L, seed=seed)
    _same_store(jw, tw)
    assert tw._cap == jw._cap and tw.total_steps == jw.total_steps
    _same_floats(jw.pagerank(), tw.pagerank().numpy())
    for seeds in ([3], [3, 17, 40], [5, 5, 9]):
        _same_floats(jw.ppr(seeds), tw.ppr(seeds).numpy())
        for k in (1, 10, 96):
            jv, ji = jw.ppr_top_k(seeds, k)
            tv, ti = tw.ppr_top_k(seeds, k)
            _same_floats(jv, tv.numpy())
            assert np.array_equal(np.asarray(ji), ti.numpy())


def test_walk_state_f32_estimates_equal_reference():
    jh, th = _pair(seed=4)
    jw = JWalkState(jh, R=5, L=20, seed=3, dtype=np.float32)
    tw = WalkState(th, R=5, L=20, seed=3, dtype=torch.float32, device=CPU)
    _same_store(jw, tw)
    _same_floats(jw.pagerank(), tw.pagerank().numpy())
    _same_floats(jw.ppr([1, 2, 3]), tw.ppr([1, 2, 3]).numpy())


def test_walk_state_batches_and_widen_equal_reference():
    """Three random batches and a fourth that widens the slab: stores and
    every stats field equal after each; a fork of each continues equal."""
    jh, th = _pair(seed=3)
    jw, tw = _stores(jh, th, R=6, L=16, seed=9)
    cur = jh
    cap0 = tw._cap
    batches = []
    for j in range(3):
        dels, ins = random_batch(cur, 0.15, seed=4 + j)
        ins = np.asarray(ins)
        batches.append((dels, ins[ins[:, 0] != ins[:, 1]]))
        cur = cur.apply_batch(*batches[-1])
    # a hub: vertex 0 gains edges to every vertex it lacks, past the width
    have = set(cur.edges[cur.edges[:, 0] == 0, 1].tolist())
    hub = np.array([[0, v] for v in range(1, 96)
                    if v not in have][:3 * cap0])
    batches.append((NONE, hub))
    cur = jh
    for dels, ins in batches:
        de, ie = effective_batch(cur, dels, ins)
        a, b = jw.apply_batch(de, ie), tw.apply_batch(de, ie)
        assert _stats(a) == _stats(b)
        cur = cur.apply_batch(dels, ins)
        _same_store(jw, tw)
        _same_floats(jw.pagerank(), tw.pagerank().numpy())
    assert b.adj_cap > cap0 and b.new_bucket
    jf, tf = jw.fork(), tw.fork()
    de, ie = effective_batch(cur, hub[:4], NONE)
    assert _stats(jf.apply_batch(de, ie)) == \
        _stats(tf.apply_batch(de, ie))
    _same_store(jf, tf)
    _same_store(jw, tw)               # the parents did not move
    assert not torch.equal(tf.walks, tw.walks)


def test_warmup_is_inert_and_records_the_reference_buckets():
    jh, th = _pair(seed=6)
    jw, tw = _stores(jh, th, R=4, L=10, seed=1)
    jw.warmup()
    tw.warmup()
    _same_store(jw, tw)
    assert jw._buckets == tw._buckets
    dels, ins = random_batch(jh, 0.02, seed=3)
    de, ie = effective_batch(jh, dels, ins)
    assert _stats(jw.apply_batch(de, ie)) == \
        _stats(tw.apply_batch(de, ie))


def test_walk_engine_run_equals_reference():
    """The snapshot-level ``run`` through each registry: a throwaway store
    at the defaults, ranks padded to n_pad, the same stats."""
    jh, th = _pair(n=48, m=180, seed=8)
    jg, tg = jh.snapshot(block_size=64), th.snapshot(block_size=64,
                                                     device=CPU)
    jr, js = jregistry.resolve("walk").run(
        jg, jpr.initial_ranks(jg, np.float64), jg.vertex_valid)
    tr, ts = registry.resolve("walk").run(
        tg, initial_ranks(tg, torch.float64), tg.vertex_valid)
    _same_floats(jr, tr.numpy())
    assert (js.sweeps, js.edges_processed, js.converged) == \
        (ts.sweeps, ts.edges_processed, ts.converged)
    with pytest.raises(ValueError, match="faults must be None"):
        registry.resolve("walk").run(tg, tr, tg.vertex_valid,
                                     faults=FaultPlan(n_threads=2))


def test_cache_size_counts_builds():
    assert twe.cache_size() == 0        # no CUDA launch on the CPU


# ---------------------------------------------------------------------------
# twins of tests/test_walk_engine.py: registry + config gating
# ---------------------------------------------------------------------------

def test_walk_engine_registered_with_capability():
    for reg in (jregistry, registry):
        assert "walk" in reg.names()
        eng = reg.resolve("walk")
        assert reg.supports_of(eng) == frozenset({"ppr"})
        assert reg.fault_domains_of(eng) == ("process",)
        assert reg.supports_of(reg.resolve("pallas")) == frozenset()


def _raises_same(exc, jexc, match, jkw, tkw) -> None:
    with pytest.raises(jexc, match=match) as jerr:
        JConfig(**jkw)
    with pytest.raises(exc, match=match) as terr:
        EngineConfig(**tkw)
    assert str(jerr.value) == str(terr.value)


@pytest.mark.parametrize("field,bad,match", [
    ("walks_per_vertex", 0, "must be >= 1"),
    ("walks_per_vertex", -3, "must be >= 1"),
    ("walk_length", 1, "must be >= 2"),
    ("walk_seed", -1, "must be >= 0"),
    ("walks_per_vertex", 2.5, "integer"),
    ("walk_length", True, "integer"),
])
def test_config_validates_walk_fields_eagerly(field, bad, match):
    kw = {"engine": "walk", field: bad}
    _raises_same(ValueError, ValueError, match, kw, kw)


@pytest.mark.parametrize("engine", ["dense", "blocked", "pallas"])
def test_sweep_engines_reject_personalization_fields(engine):
    for kw, match in (({"walks_per_vertex": 8}, "'ppr' capability"),
                      ({"walk_length": 16, "walk_seed": 1},
                       "engine='walk'")):
        _raises_same(CapabilityError, JCapabilityError, match,
                     {"engine": engine, **kw}, {"engine": engine, **kw})


def test_walk_engine_rejects_sweep_fault_and_integrity_knobs():
    _raises_same(ValueError, ValueError, "sweep",
                 {"engine": "walk", "faults": JFaultPlan(n_threads=2)},
                 {"engine": "walk", "faults": FaultPlan(n_threads=2)})
    _raises_same(ValueError, ValueError, "integrity",
                 {"engine": "walk", "integrity": JIntegrityConfig()},
                 {"engine": "walk", "integrity": IntegrityConfig()})


def test_walk_config_resolves_the_reference_defaults():
    for kw in ({}, {"walks_per_vertex": 3, "walk_length": 7,
                    "walk_seed": 2 ** 33}):
        j, t = JConfig(engine="walk", **kw), EngineConfig(engine="walk", **kw)
        for f in ("resolved_walks_per_vertex", "resolved_walk_length",
                  "resolved_walk_seed"):
            assert getattr(j, f) == getattr(t, f), f


# ---------------------------------------------------------------------------
# twins of tests/test_walk_engine.py: the walk store
# ---------------------------------------------------------------------------

def test_delta_regeneration_equals_full_rebuild():
    jh, th = _pair(seed=3)
    jw, tw = _stores(jh, th, R=6, L=16, seed=9)
    dels, ins = random_batch(jh, 0.15, seed=4)
    ins = np.asarray(ins)
    ins = ins[ins[:, 0] != ins[:, 1]]
    de, ie = effective_batch(jh, dels, ins)
    jstats, stats = jw.apply_batch(de, ie), tw.apply_batch(de, ie)
    full = WalkState(th.apply_batch(dels, ins), R=6, L=16, seed=9,
                     device=CPU)
    assert torch.equal(tw.walks, full.walks)
    assert torch.equal(tw.counts, full.counts)
    assert 0 < stats.regenerated_walks <= stats.touched_walk_mass
    assert stats.regenerated_walks < stats.total_walks
    assert _stats(jstats) == _stats(stats)
    _same_store(jw, tw)


def test_delete_reinsert_is_noop_on_walk_buffers():
    jh, th = _pair(seed=5)
    jw, tw = _stores(jh, th, R=5, L=14, seed=2)
    w0, c0 = tw.walks.clone(), tw.counts.clone()
    edges = th.edges[:5]
    for ws, hg in ((jw, jh), (tw, jh)):
        ws.apply_batch(*effective_batch(hg, edges, NONE))
    assert not torch.equal(tw.walks, w0)        # the delta took effect
    _same_store(jw, tw)
    hg2 = jh.apply_batch(edges, NONE)
    for ws in (jw, tw):
        ws.apply_batch(*effective_batch(hg2, NONE, edges))
    assert torch.equal(tw.walks, w0)
    assert torch.equal(tw.counts, c0)
    _same_store(jw, tw)


def test_estimates_track_oracles():
    jh = jpowerlaw(128, 5, seed=11)
    th = powerlaw(128, 5, seed=11)
    assert np.array_equal(jh.edges, th.edges)
    g = th.snapshot(block_size=64, device=CPU)
    jw, tw = _stores(jh, th, R=128, L=48, seed=1)
    _same_store(jw, tw)
    ref = tpr.numpy_reference(g, iterations=300)[:th.n]
    est = tw.pagerank().numpy()
    _same_floats(jw.pagerank(), est)
    assert float(np.abs(est - ref).sum()) < 0.35
    seeds = np.array([3, 17, 40])
    pref = tpr.ppr_numpy_reference(g, seeds, iterations=300)[:th.n]
    pest = tw.ppr(seeds).numpy()
    _same_floats(jw.ppr(seeds), pest)
    assert float(np.abs(pest - pref).sum()) < 0.8
    vals, idx = tw.ppr_top_k(seeds, 5)
    order = np.argsort(pest)[::-1][:5]
    np.testing.assert_allclose(vals.numpy(), pest[order])
    jv, ji = jw.ppr_top_k(seeds, 5)
    _same_floats(jv, vals.numpy())
    assert np.array_equal(np.asarray(ji), idx.numpy())


def test_accuracy_improves_with_R():
    jh = jpowerlaw(96, 5, seed=7)
    th = powerlaw(96, 5, seed=7)
    g = th.snapshot(block_size=64, device=CPU)
    seeds = np.array([1, 2, 5])
    ref = tpr.ppr_numpy_reference(g, seeds, iterations=300)[:th.n]
    errs = []
    for R in (4, 32, 256):
        jw, tw = _stores(jh, th, R=R, L=48, seed=3)
        p = tw.ppr(seeds).numpy()
        _same_floats(jw.ppr(seeds), p)
        errs.append(float(np.abs(p - ref).sum()))
    assert errs[-1] < errs[0]
