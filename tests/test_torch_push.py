"""The port's residual forward-push driver against the JAX package's.

The same inputs (numpy, from a seed) go through ``repro.core.push_engine``
(JAX, ``backend="xla"``) and ``repro_torch.core.push_engine`` (the port on
the CPU, its plain kernels), and the same streams through the two
``driver="push"`` sessions.  The counters — sweeps, pushed and candidate
blocks, edges, converged, stalled — must be EQUAL (the port's gated sweeps
follow the reference's loop sweep for sweep); ranks and residuals agree
within 1e-12 in f64 (summation order only), and the residual invariant
``r = b + M·p − p`` holds to 1e-12 after every update, as
``tests/test_push_engine.py`` holds the reference to.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import delta as jdelta
from repro.core import push_engine as jpshe
from repro.core.incremental import effective_batch as j_effective_batch
from repro.core.pallas_engine import build_pull_matrix as j_build
from repro.core.stream import run_stream as j_run_stream
from repro.graphs import generators as jgen
from repro.kernels.block_spmv import ops as jops
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.convert import block_sparse_from_numpy, session_from_numpy
from repro_torch.core import push_engine as tpshe
from repro_torch.core.faults import FaultPlan
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.pagerank import numpy_reference
from repro_torch.core.stream import run_stream as t_run_stream
from repro_torch.graphs import generators as tgen
from repro_torch.kernels.block_spmv import ops as tops

ALPHA = 0.85
TAU = 1e-10
B = 64
COUNTERS = ("sweeps", "iterations", "blocks_processed", "edges_processed",
            "converged")
# stats vector entries that must be equal: sweeps, pushed blocks, candidate
# blocks, edges, converged, stalled (l1 and max|r| are float sums)
EXACT = [0, 1, 2, 3, 6, 7]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the plain kernels' many small ops gain
    nothing from a thread pool, and a pool per test worker spins against
    the other workers' (the suite runs several workers on few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bound(n):
    """Both drivers stop at per-vertex residual/change ≤ tau, so each sits
    within ||r||_1·α/(1−α) ≤ n·tau·α/(1−α) of the fixed point."""
    return n * TAU * ALPHA / (1.0 - ALPHA)


def _jcfg(driver="push", **kw):
    return JConfig(engine="pallas", backend="xla", block_size=B,
                   driver=driver, tau=TAU, **kw)


def _tcfg(driver="push", **kw):
    return TConfig(block_size=B, driver=driver, tau=TAU, **kw)


def _open(jg, driver="push", **kw):
    js = JSession.from_graph(jg, config=_jcfg(driver, **kw))
    ts = TSession.from_graph(THostGraph(jg.n, jg.edges),
                             config=_tcfg(driver, **kw), device="cpu")
    return js, ts


def _stream(hg, k, *, rate=None, seed=50):
    batches, cur = [], hg
    for i in range(k):
        dels, ins = jdelta.random_batch(cur, rate or 8 / cur.m, seed=seed + i)
        batches.append((dels, ins))
        cur = cur.apply_batch(dels, ins)
    return batches, cur


def _drift(ts):
    """Device residual against the invariant rebuilt from host truth."""
    host = tpshe.residual_from_host(ts.hg, ts._out_deg_host, ts.R.numpy(),
                                    ALPHA)
    return float(np.abs(ts._residual.numpy() - host).max())


def _assert_step(a, b, js, ts):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert b.pushed_blocks == a.pushed_blocks
    np.testing.assert_allclose(b.residual_mass, a.residual_mass, rtol=1e-12,
                               atol=0)
    assert np.abs(ts.R.numpy() - np.asarray(js.R)).max() <= 1e-12
    assert np.abs(ts._residual.numpy()
                  - np.asarray(js._residual)).max() <= 1e-12


# ---------------------------------------------------------------------------
# (a) the fused push loop against the reference's
# ---------------------------------------------------------------------------

def _operands(jg, block):
    g = jg.snapshot(block_size=block)
    m = j_build(g, padded=True)
    tm = block_sparse_from_numpy(np.asarray(m.tiles), np.asarray(m.tile_cols),
                                 np.asarray(m.tile_idx), m.n_rows, m.n_cols,
                                 m.block, device="cpu")
    return g, m, tm, np.asarray(jops.block_adjacency(m))


def _drive_both(jg, block, P0, R0):
    g, m, tm, bmat = _operands(jg, block)
    valid, out_deg = np.array(g.vertex_valid), np.array(g.out_deg)
    Pj, Rj, svj, _ = jpshe._push_driver(
        m, jnp.asarray(P0), jnp.asarray(R0), g.vertex_valid, g.out_deg,
        g.block_out_edges(), jnp.asarray(bmat),
        jnp.ones((g.n_blocks,), bool), jnp.asarray(ALPHA), jnp.asarray(TAU),
        n=g.n, block_size=block, max_iterations=500, interpret=True,
        backend="xla")
    Pt, Rt, svt, syncs = tpshe._push_driver(
        tm, torch.from_numpy(P0), torch.from_numpy(R0),
        torch.from_numpy(valid), torch.from_numpy(out_deg),
        torch.from_numpy(bmat), torch.tensor(ALPHA, dtype=torch.float64),
        torch.tensor(TAU, dtype=torch.float64), n=g.n, block_size=block,
        max_iterations=500)
    svj = np.asarray(svj)
    np.testing.assert_array_equal(svt[EXACT], svj[EXACT])
    np.testing.assert_allclose(svt[4:6], svj[4:6], rtol=1e-12, atol=0)
    assert np.abs(Pt.numpy() - np.asarray(Pj)).max() <= 1e-12
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() <= 1e-12
    assert svt[6] == 1 and svt[0] > 0
    # one poll per chunk of gated sweeps, the converging sweep included
    assert syncs == int(svt[0]) // 8 + 1
    return np.asarray(Pj), g


@pytest.mark.parametrize("block", [8, 32, 64])
def test_push_driver_equals_jax(block):
    """The cold start (p = 0, r = b), then the same drive after one seeded
    delta batch (the reference's residual seed on the host and scatter)."""
    jg = jgen.grid_road(20, seed=3)
    g = jg.snapshot(block_size=block)
    valid = np.asarray(g.vertex_valid)
    P0 = np.zeros(g.n_pad)
    R0 = np.where(valid, (1.0 - ALPHA) / g.n, 0.0)
    P, g = _drive_both(jg, block, P0, R0)

    dels, ins = jdelta.random_batch(jg, 0.02, seed=11, deletions_frac=0.3)
    de, ie = j_effective_batch(jg, dels, ins)
    jg2 = jg.apply_batch(dels, ins)
    g2 = jg2.snapshot(block_size=block)
    sources = np.unique(np.concatenate([de[:, 0], ie[:, 0]]))
    R_prev = jpshe.residual_from_host(jg, np.asarray(g.out_deg), P, ALPHA)
    sidx, svals = jpshe.residual_seed_host(
        jg, jg2, sources, P[sources], np.asarray(g.out_deg)[sources],
        np.asarray(g2.out_deg)[sources], ALPHA)
    R1 = np.asarray(jpshe.scatter_residual(jnp.asarray(R_prev), sidx, svals))
    _drive_both(jg2, block, P, R1)


def test_push_bucketed_equals_jax_on_candidate_rows():
    jg = jgen.rmat(8, avg_degree=5, seed=2)
    g, m, tm, bmat = _operands(jg, 32)
    rng = np.random.default_rng(4)
    x = rng.random(g.n_pad)
    src_cb = rng.random(g.n_blocks) < 0.4
    cand = (bmat & src_cb[None, :]).any(axis=1)
    ids = np.full(g.n_blocks, -1, np.int32)
    ids[:cand.sum()] = np.nonzero(cand)[0]
    yj = np.asarray(jops.block_spmv_push_bucketed(
        m, jnp.asarray(x), jnp.asarray(src_cb), jnp.asarray(ids),
        jnp.asarray(np.int32(cand.sum())), backend="xla"))
    yt = tops.block_spmv_push_bucketed(
        tm, torch.from_numpy(x), torch.from_numpy(src_cb),
        torch.from_numpy(ids), torch.tensor(int(cand.sum()))).numpy()
    rows = np.repeat(cand, 32)
    assert rows.any()
    np.testing.assert_allclose(yt[rows], yj[rows], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# (b), (c) residual seed, scatter and full rebuild
# ---------------------------------------------------------------------------

def test_residual_seed_host_equals_jax():
    jg = jgen.rmat(8, avg_degree=5, seed=5)
    tg = THostGraph(jg.n, jg.edges)
    dels, ins = jdelta.random_batch(jg, 0.05, seed=6, deletions_frac=0.4)
    jg2, tg2 = jg.apply_batch(dels, ins), tg.apply_batch(dels, ins)
    rng = np.random.default_rng(7)
    sources = np.unique(np.concatenate([dels[:, 0], ins[:, 0]]))
    p = rng.random(len(sources))
    d0, d1 = rng.integers(1, 9, len(sources)), rng.integers(1, 9,
                                                             len(sources))
    ij, vj = jpshe.residual_seed_host(jg, jg2, sources, p, d0, d1, ALPHA)
    it, vt = tpshe.residual_seed_host(tg, tg2, sources, p, d0, d1, ALPHA)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(vt, vj)
    assert len(np.unique(it)) < len(it)         # duplicates are the case


def test_scatter_residual_duplicates_deterministic_in_list_order():
    rng = np.random.default_rng(8)
    n_pad = 256
    r = rng.standard_normal(n_pad) * 1e-7
    idx = rng.integers(0, 40, 900)              # ~22 occurrences per index
    vals = rng.standard_normal(900) * 1e-8
    rt = torch.from_numpy(r)
    a = tpshe.scatter_residual(rt, idx, vals)
    b = tpshe.scatter_residual(rt, idx, vals)
    assert torch.equal(a, b)
    assert torch.equal(rt, torch.from_numpy(r))     # input left as it was
    seq = r.copy()
    for i, v in zip(idx, vals):                 # a sequential scatter
        seq[i] += v
    np.testing.assert_array_equal(a.numpy(), seq)
    ref = np.asarray(jpshe.scatter_residual(jnp.asarray(r), idx, vals))
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-15, atol=0)
    assert torch.equal(tpshe.scatter_residual(rt, idx[:0], vals[:0]), rt)


def test_residual_full_equals_jax_and_host():
    jg = jgen.rmat(8, avg_degree=5, seed=9)
    g, m, tm, _ = _operands(jg, B)
    rng = np.random.default_rng(10)
    P = np.where(np.asarray(g.vertex_valid), rng.random(g.n_pad) / g.n, 0)
    rj = np.asarray(jpshe.residual_full(
        m, jnp.asarray(P), g.vertex_valid, g.out_deg, jnp.asarray(ALPHA),
        n=g.n, interpret=True, backend="xla"))
    rt = tpshe.residual_full(
        tm, torch.from_numpy(P), torch.from_numpy(np.asarray(g.vertex_valid)),
        torch.from_numpy(np.asarray(g.out_deg)),
        torch.tensor(ALPHA, dtype=torch.float64), n=g.n).numpy()
    host = tpshe.residual_from_host(THostGraph(jg.n, jg.edges),
                                    np.asarray(g.out_deg), P, ALPHA)
    assert np.abs(rt - rj).max() <= 1e-12
    assert np.abs(rt - host).max() <= 1e-12
    np.testing.assert_array_equal(
        host, jpshe.residual_from_host(jg, np.asarray(g.out_deg), P, ALPHA))


# ---------------------------------------------------------------------------
# (d) session twins of tests/test_push_engine.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["grid_road", "rmat"])
def test_push_stream_tracks_jax_batch_by_batch(graph):
    jg = (jgen.grid_road(16, seed=7) if graph == "grid_road"
          else jgen.rmat(8, avg_degree=4, seed=7))
    js, ts = _open(jg)
    assert np.abs(ts.R.numpy() - np.asarray(js.R)).max() <= 1e-12
    js.warmup()
    ts.warmup()
    for i in range(6):
        dels, ins = jdelta.random_batch(js.hg, 1e-2, seed=100 + i,
                                        deletions_frac=0.2)
        a, b = js.update(dels, ins), ts.update(dels, ins)
        _assert_step(a, b, js, ts)
        # the p_src read, then one poll per chunk of 8 gated sweeps
        assert b.host_syncs == 1 + b.stats.sweeps // 8 + 1
        assert _drift(ts) <= 1e-12
    rep = ts.report()
    assert rep.retraces_post_warmup == 0
    assert rep.sweeps_history == js.report().sweeps_history
    assert rep.edges_processed_history == js.report().edges_processed_history


def test_invariant_exact_across_updates():
    jg = jgen.rmat(8, avg_degree=5, seed=7)
    js, ts = _open(jg)
    batches, _ = _stream(jg, 4, rate=3e-2, seed=90)
    for dels, ins in batches:
        a, b = js.update(dels, ins), ts.update(dels, ins)
        assert b.converged
        _assert_step(a, b, js, ts)
        assert _drift(ts) < 1e-12


def test_cold_solve_matches_reference():
    jg = jgen.rmat(9, avg_degree=6, seed=3)
    js, ts = _open(jg)
    ref = numpy_reference(ts.hg.snapshot(block_size=B, device="cpu"),
                          iterations=300)
    assert np.abs(ts.ranks[:jg.n] - ref[:jg.n]).max() < _bound(jg.n)
    assert float(ts._residual.abs().max()) < 4 * TAU
    assert np.abs(ts.R.numpy() - np.asarray(js.R)).max() <= 1e-12
    assert np.abs(ts._residual.numpy()
                  - np.asarray(js._residual)).max() <= 1e-12
    assert _drift(ts) <= 1e-12


def test_delete_then_reinsert_returns_to_fixed_point():
    jg = jgen.kmer_chains(1 << 9, seed=4)
    js, ts = _open(jg)
    before = ts.ranks.copy()
    rng = np.random.default_rng(5)
    pick = rng.choice(jg.m, size=12, replace=False)
    edges = np.stack([jg._keys[pick] // jg.n, jg._keys[pick] % jg.n], axis=1)
    zero = np.zeros((0, 2), np.int64)
    for dels, ins in ((edges, zero), (zero, edges)):
        a, b = js.update(dels, ins), ts.update(dels, ins)
        assert b.converged
        _assert_step(a, b, js, ts)
    assert np.abs(ts.ranks - before).max() < 2 * _bound(jg.n)


@pytest.mark.parametrize("family,seed", [
    ("rmat", 1), ("rmat", 5), ("powerlaw", 2), ("kmer", 3),
])
def test_push_pull_same_fixed_point(family, seed):
    hg = {"rmat": lambda: tgen.rmat(8, avg_degree=5, seed=seed),
          "powerlaw": lambda: tgen.powerlaw(300, avg_degree=6, seed=seed),
          "kmer": lambda: tgen.kmer_chains(400, seed=seed)}[family]()
    batches, _ = _stream(hg, 2, rate=2e-2, seed=seed * 13 + 1)
    # a delete+reinsert pair of an original edge
    e = np.array([[int(hg._keys[0] // hg.n), int(hg._keys[0] % hg.n)]],
                 np.int64)
    zero = np.zeros((0, 2), np.int64)
    batches += [(e, zero), (zero, e)]
    finals = {}
    for driver in ("pull", "push"):
        sess = TSession.from_graph(hg, config=_tcfg(driver), device="cpu")
        for dels, ins in batches:
            assert sess.update(dels, ins).converged, driver
        finals[driver] = sess.ranks[:hg.n].copy()
        sess.close()
    gap = float(np.abs(finals["push"] - finals["pull"]).max())
    assert gap < 2 * _bound(hg.n), (family, seed, gap)


def test_run_stream_push_does_less_edge_work_than_pull():
    jg = jgen.kmer_chains(1 << 10, seed=4)
    hg = THostGraph(jg.n, jg.edges)
    ref0 = numpy_reference(hg.snapshot(block_size=B, device="cpu"),
                           iterations=300)
    batches, cur = _stream(jg, 4, seed=70)
    reps = {d: t_run_stream(hg, batches, block_size=B, r0=ref0,
                            active_policy="rc", driver=d, device="cpu")
            for d in ("pull", "push")}
    ref = numpy_reference(THostGraph(cur.n, cur.edges).snapshot(
        block_size=B, device="cpu"), iterations=300)
    edges = {}
    for d, rep in reps.items():
        assert rep.retraces_post_warmup == 0, d
        assert rep.all_converged, d
        assert np.abs(rep.final_ranks[:cur.n].numpy()
                      - ref[:cur.n]).max() < 1e-8, d
        edges[d] = sum(r.stats.edges_processed for r in rep.results)
    assert edges["push"] < edges["pull"], edges
    jrep = j_run_stream(jg, batches, block_size=B, r0=jnp.asarray(ref0),
                        active_policy="rc", driver="push", backend="xla")
    assert [r.stats.edges_processed for r in jrep.results] == \
        [r.stats.edges_processed for r in reps["push"].results]


def test_report_work_accounting():
    hg = tgen.rmat(8, avg_degree=5, seed=7)
    batches, _ = _stream(hg, 3, rate=2e-2, seed=20)
    sess = TSession.from_graph(hg, config=_tcfg(), device="cpu")
    for dels, ins in batches:
        res = sess.update(dels, ins)
        assert res.residual_mass is not None and res.residual_mass >= 0
        assert res.pushed_blocks is not None and res.pushed_blocks > 0
    rep = sess.report()
    assert rep.driver == "push"
    assert len(rep.sweeps_history) == 3
    assert rep.edges_processed_history == [
        r.stats.edges_processed for r in sess._history]
    assert rep.residual_mass_last == sess._history[-1].residual_mass
    assert rep.pushed_blocks == sum(r.pushed_blocks for r in sess._history)
    assert rep.device_bytes["residual"] == sess._residual.nbytes
    sess.close()
    assert sess._residual is None

    pull = TSession.from_graph(hg, config=_tcfg("pull"), device="cpu")
    pull.update(*batches[0])
    prep = pull.report()
    assert prep.driver == "pull"
    assert prep.residual_mass_last is None and prep.pushed_blocks is None
    assert prep.device_bytes["residual"] == 0
    pull.close()


def test_dt_update_and_replay_recompute_rejected():
    hg = tgen.rmat(7, avg_degree=4, seed=2)
    sess = TSession.from_graph(hg, config=_tcfg(), device="cpu")
    dels, ins = jdelta.random_batch(hg, 1e-2, seed=8)
    with pytest.raises(ValueError, match="dt"):
        sess.update(dels, ins, variant="dt")
    for variant in ("df", "dt"):
        with pytest.raises(ValueError, match="static' or 'nd"):
            sess.recompute(variant)
    with pytest.raises(ValueError, match="invalid"):
        sess.recompute("nope")
    # a pull session replays the last batch, and has none yet
    pull = TSession.from_graph(hg, config=_tcfg("pull"), device="cpu")
    for variant in ("df", "dt"):
        with pytest.raises(ValueError, match="no batch"):
            pull.recompute(variant)


@pytest.mark.parametrize("driver", ["pull", "push"])
@pytest.mark.parametrize("variant", ["nd", "static"])
def test_recompute_matches_jax(driver, variant):
    jg = jgen.rmat(8, avg_degree=5, seed=9)
    js, ts = _open(jg, driver)
    dels, ins = jdelta.random_batch(jg, 2e-2, seed=12, deletions_frac=0.2)
    js.update(dels, ins)
    ts.update(dels, ins)
    a, b = js.recompute(variant), ts.recompute(variant)
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c
    assert b.converged
    assert np.abs(b.ranks.numpy() - np.asarray(a.ranks)).max() <= 1e-12
    assert torch.equal(ts.R, b.ranks)
    ref = numpy_reference(ts.hg.snapshot(block_size=B, device="cpu"),
                          iterations=300)
    assert np.abs(ts.ranks[:jg.n] - ref[:jg.n]).max() < _bound(jg.n)
    if driver == "push":
        assert _drift(ts) <= 1e-12


def test_nd_update_rebuilds_residual():
    jg = jgen.rmat(8, avg_degree=5, seed=9)
    js, ts = _open(jg)
    dels, ins = jdelta.random_batch(jg, 2e-2, seed=3)
    a, b = js.update(dels, ins, variant="nd"), ts.update(dels, ins,
                                                          variant="nd")
    assert b.converged
    _assert_step(a, b, js, ts)
    assert _drift(ts) < 1e-12


@pytest.mark.parametrize("kw,err,match", [
    ({"driver": "spin"}, ValueError, "driver='spin' invalid"),
    ({"engine": "dense", "driver": "push"}, ValueError, "pallas"),
    ({"engine": "blocked", "driver": "push"}, ValueError, "pallas"),
    ({"mode": "bb", "driver": "push"}, ValueError, "mode must be 'lf'"),
    ({"faults": FaultPlan(n_threads=2), "driver": "push"}, ValueError,
     "fault tables"),
    # the reference refuses these for good, before any later-slice refusal
    ({"integrity": {"mass_tol": 1e-6}, "driver": "push"}, ValueError,
     "driver='push' does not support integrity="),
    ({"fault_domain": object(), "driver": "push"}, ValueError,
     "driver='push' does not host fault domains on the drive path"),
])
def test_push_config_rules(kw, err, match):
    with pytest.raises(err, match=match):
        TConfig(**kw)


def test_push_config_constructs_and_pull_is_default():
    assert TConfig().driver == "pull"
    cfg = TConfig(driver="push", engine="pallas")
    assert cfg.driver == "push" and cfg.resolved_engine == "pallas"


# ---------------------------------------------------------------------------
# (e) generators, (f) carrying a JAX push session across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["kmer_chains", "powerlaw"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_equal_jax(family, seed):
    kw = {"kmer_chains": dict(n=700), "powerlaw": dict(n=500,
                                                       avg_degree=6)}[family]
    jg = getattr(jgen, family)(seed=seed, **kw)
    tg = getattr(tgen, family)(seed=seed, **kw)
    assert tg.n == jg.n and tg.m > 0
    np.testing.assert_array_equal(tg.edges, jg.edges)


def test_session_from_numpy_carries_the_residual():
    jg = jgen.grid_road(16, seed=8)
    js = JSession.from_graph(jg, config=_jcfg())
    dels, ins = jdelta.random_batch(js.hg, 0.02, seed=1, deletions_frac=0.2)
    js.update(dels, ins)        # the residual is now a seeded one
    ts = session_from_numpy(js.hg.n, js.hg.edges, np.asarray(js.R),
                            _tcfg(), device="cpu",
                            residual=np.asarray(js._residual))
    np.testing.assert_array_equal(ts.ranks, np.asarray(js.R))
    np.testing.assert_array_equal(ts._residual.numpy(),
                                  np.asarray(js._residual))
    for i in range(3):
        dels, ins = jdelta.random_batch(js.hg, 0.02, seed=2 + i,
                                        deletions_frac=0.2)
        _assert_step(js.update(dels, ins), ts.update(dels, ins), js, ts)
    rebuilt = session_from_numpy(js.hg.n, js.hg.edges, np.asarray(js.R),
                                 _tcfg(), device="cpu")
    assert _drift(rebuilt) <= 1e-12
    with pytest.raises(ValueError, match="push"):
        session_from_numpy(js.hg.n, js.hg.edges, np.asarray(js.R),
                           _tcfg("pull"), device="cpu",
                           residual=np.asarray(js._residual))
