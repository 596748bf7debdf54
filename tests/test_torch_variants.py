"""The port's variant matrix on the stream session against the JAX package:
``update(variant="dt")``, the ``recompute("df"|"dt")`` replay of the last
batch, and the frontier, graph, delta and generator helpers they run on.

The same inputs (numpy, from a seed) go through ``repro`` (JAX on the CPU,
``engine="pallas", backend="xla"``) and ``repro_torch`` (``device="cpu"``,
the plain kernels).  Boolean marks and edge streams must be EQUAL, counters
(sweeps, iterations, blocks, edges, converged) EQUAL, f64 ranks within
1e-12, and the final ranks within 1e-9 of the numpy oracle.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.core import delta as jdelta
from repro.core import frontier as jfr
from repro.core import graph as jgraph
from repro.graphs import generators as jgen
from repro_torch.api.config import EngineConfig as TConfig
from repro_torch.api.session import PageRankSession as TSession
from repro_torch.core import delta as tdelta
from repro_torch.core import frontier as tfr
from repro_torch.core import graph as tgraph
from repro_torch.core.graph import HostGraph as THostGraph
from repro_torch.core.pagerank import numpy_reference, restart_vector
from repro_torch.graphs import generators as tgen

B = 64
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


def _graph(name):
    return {"rmat": lambda: jgen.rmat(10, avg_degree=6, seed=3),
            "grid_road": lambda: jgen.grid_road(32, seed=7)}[name]()


def _pair(jg, dels, ins, block=B):
    """JAX and port snapshots of G^{t-1}, G^t and the packed batch."""
    jg1 = jg.apply_batch(dels, ins)
    tg = THostGraph(jg.n, jg.edges)
    tg1 = tg.apply_batch(dels, ins)
    j0, j1 = jg.snapshot(block_size=block), jg1.snapshot(block_size=block)
    t0 = tg.snapshot(block_size=block, device="cpu")
    t1 = tg1.snapshot(block_size=block, device="cpu")
    return (j0, j1, jfr.batch_to_device(j1, dels, ins),
            t0, t1, tfr.batch_to_device(t1, dels, ins))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _assert_counters(a, b):
    for c in COUNTERS:
        assert getattr(b.stats, c) == getattr(a.stats, c), c


# ---------------------------------------------------------------------------
# graph and frontier helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["rmat", "grid_road"])
def test_frontier_marking_equals_jax(graph):
    jg = _graph(graph)
    dels, ins = jdelta.random_batch(jg, 5e-3, seed=11, deletions_frac=0.3)
    j0, j1, jb, t0, t1, tb = _pair(jg, dels, ins)
    _eq(tb, jb)
    _eq(tfr.update_sources_indicator(t1, tb),
        jfr.update_sources_indicator(j1, jb))
    _eq(tfr.initial_affected(t0, t1, tb), jfr.initial_affected(j0, j1, jb))
    for hops in (0, 1, 3, 9):
        _eq(tfr.dt_affected(t0, t1, tb, max_hops=hops),
            jfr.dt_affected(j0, j1, jb, max_hops=hops))
    rng = np.random.default_rng(5)
    for coverage in (0.0, 0.3, 1.0):
        fp = rng.random(jb.shape[0]) < coverage
        ja, jc, jr = jfr.initial_affected_with_helping(j0, j1, jb,
                                                       jnp.asarray(fp))
        ta, tc, tr = tfr.initial_affected_with_helping(t0, t1, tb, fp)
        _eq(ta, ja)
        _eq(tc, jc)
        assert tr == jr
    flags = rng.random(t1.n_pad) < 0.05
    rc = rng.random(t1.n_pad) < 0.02
    ja, jrc = jfr.expand_frontier(j1, jnp.asarray(flags), jnp.asarray(flags),
                                  jnp.asarray(rc))
    ta, trc = tfr.expand_frontier(t1, torch.tensor(flags),
                                  torch.tensor(flags), torch.tensor(rc))
    _eq(ta, ja)
    _eq(trc, jrc)


def test_dt_bfs_polls_once_per_chunk():
    """The hop count is the reference loop's (every hop from a non-empty
    frontier, the last, empty-handed one included; a numpy level-by-level
    walk here), and the frontier is read once per chunk of HOPS_PER_POLL
    hops."""
    jg = jgen.grid_road(24, seed=1)
    dels, ins = jdelta.random_batch(jg, 2e-3, seed=2, deletions_frac=0.0)
    _, _, _, t0, t1, tb = _pair(jg, dels, ins, block=32)
    aff, hops, polls = tfr._dt_reach(t0, t1, tb)
    src, dst = (a.numpy() for a in (t1.osrc[:t1.m], t1.odst[:t1.m]))
    seen = tfr.initial_affected(t0, t1, tb).numpy()
    front, depth = seen.copy(), 0
    while front.any():
        nxt = np.zeros_like(seen)
        nxt[dst[front[src]]] = True
        front = nxt & ~seen
        seen |= front
        depth += 1
    assert hops == depth and hops > tfr.HOPS_PER_POLL
    assert polls == -(-hops // tfr.HOPS_PER_POLL)
    np.testing.assert_array_equal(aff.numpy(), seen)
    empty = tfr.batch_to_device(t1, np.zeros((0, 2)), np.zeros((0, 2)))
    aff, hops, polls = tfr._dt_reach(t0, t1, empty)
    assert (hops, polls) == (0, 1) and not aff.any()
    assert tfr._dt_reach(t0, t1, tb, max_hops=3)[1:] == (3, 1)


@pytest.mark.parametrize("graph", ["rmat", "grid_road"])
def test_graph_helpers_equal_jax(graph):
    jg = _graph(graph)
    j = jg.snapshot(block_size=B)
    t = THostGraph(jg.n, jg.edges).snapshot(block_size=B, device="cpu")
    rng = np.random.default_rng(9)
    r = rng.random(t.n_pad)
    flags = rng.random(t.n_pad) < 0.1
    _eq(tgraph.out_neighbor_or(t, torch.tensor(flags)),
        jgraph.out_neighbor_or(j, jnp.asarray(flags)))
    np.testing.assert_allclose(
        tgraph.contributions(t, torch.tensor(r)).numpy(),
        np.asarray(jgraph.contributions(j, jnp.asarray(r))), rtol=0,
        atol=1e-15)
    # pull_all's segment lengths: the reference's in-degrees, found once
    _eq(t.in_deg, np.bincount(np.asarray(j.dst)[:j.m], minlength=t.n_pad))
    assert t.in_deg is t.in_deg
    seeds = [3, 17, 200]
    for pers in (None, restart_vector(t, seeds)):
        tp = tgraph.pull_all(t, torch.tensor(r), alpha=0.85,
                             personalization=pers)
        jp = jgraph.pull_all(j, jnp.asarray(r), alpha=0.85,
                             personalization=None if pers is None
                             else jnp.asarray(pers))
        assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-12
    r32 = torch.tensor(r[:100], dtype=torch.float32)
    _eq(tgraph.pad_ranks(t, r32), jgraph.pad_ranks(j, jnp.asarray(r32)))
    assert tgraph.pad_ranks(t, r32).dtype == torch.float32
    long = np.arange(t.n_pad + 40, dtype=np.float64)
    _eq(tgraph.pad_ranks(t, long), jgraph.pad_ranks(j, jnp.asarray(long)))


# ---------------------------------------------------------------------------
# delta and generator helpers: identical arrays per seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_delta_helpers_and_temporal_stream_equal_jax(seed):
    jg = jgen.rmat(9, avg_degree=4, seed=seed)
    tg = tgen.rmat(9, avg_degree=4, seed=seed)
    np.testing.assert_array_equal(
        tdelta.pure_deletion_batch(tg, 1e-2, seed=seed),
        jdelta.pure_deletion_batch(jg, 1e-2, seed=seed))
    for pref in (True, False):
        ts = tgen.temporal_stream(300, 5000, seed=seed, preferential=pref)
        js = jgen.temporal_stream(300, 5000, seed=seed, preferential=pref)
        np.testing.assert_array_equal(ts, js)
    tp, tb = tdelta.temporal_batches(ts, prefix_frac=0.8, batch_frac=0.03)
    jp, jb = jdelta.temporal_batches(js, prefix_frac=0.8, batch_frac=0.03)
    np.testing.assert_array_equal(tp, jp)
    tb, jb = list(tb), list(jb)
    assert len(tb) == len(jb) > 1
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    batches = [jdelta.random_batch(jg, 0.02, seed=int(s))
               for s in rng.integers(0, 1000, 4)]
    batches.append((batches[0][1][:5], batches[1][0][:3]))   # re-toggles
    for a, b in zip(tdelta.coalesce_batches(batches, jg.n),
                    jdelta.coalesce_batches(batches, jg.n)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the stream session: dt updates and the df/dt replays
# ---------------------------------------------------------------------------

def _open(jg, **cfg):
    js = JSession.from_graph(jg, config=JConfig(
        engine="pallas", backend="xla", block_size=B, tau=TAU, **cfg))
    ts = TSession.from_graph(THostGraph(jg.n, jg.edges), config=TConfig(
        block_size=B, tau=TAU, **cfg), device="cpu")
    return js, ts


def _step(a, b):
    _assert_counters(a, b)
    assert np.abs(b.ranks.numpy() - np.asarray(a.ranks)).max() <= 1e-12


@pytest.mark.parametrize("graph", ["rmat", "grid_road"])
def test_dt_stream_and_replays_track_jax(graph):
    """Three dt updates, then recompute("df") and recompute("dt") of the
    last batch, step by step against the JAX stream session."""
    js, ts = _open(_graph(graph))
    js.warmup()
    ts.warmup()
    for i in range(3):
        dels, ins = jdelta.random_batch(js.hg, 5e-3, seed=40 + i,
                                        deletions_frac=0.2)
        a, b = js.update(dels, ins, variant="dt"), ts.update(dels, ins,
                                                             variant="dt")
        _step(a, b)
        np.testing.assert_array_equal(ts.hg.edges, js.hg.edges)
        hops, polls = ts._dt_bfs
        assert polls == max(1, -(-hops // tfr.HOPS_PER_POLL))
        # BFS polls, the kernel-choice read, then one poll per 8 sweeps
        assert b.host_syncs == polls + 1 + -(-b.stats.sweeps // 8)
    for variant in ("df", "dt"):
        _step(js.recompute(variant), ts.recompute(variant))
    assert ts.report().retraces_post_warmup == 0
    ref = numpy_reference(ts.hg.snapshot(block_size=B, device="cpu"),
                          iterations=300)
    assert np.abs(ts.ranks[:ts.n] - ref[:ts.n]).max() <= 1e-9


@pytest.mark.parametrize("variant", ["df", "dt"])
def test_replay_right_after_update_is_bit_exact(variant):
    """The reference's recompute(v) right after update(v) gives the update's
    ranks bit for bit (its own test pins df; dt checked here); the port's
    does too, counters included."""
    jg = jgen.rmat(10, avg_degree=6, seed=8)
    js, ts = _open(jg)
    dels, ins = jdelta.random_batch(jg, 5e-3, seed=9, deletions_frac=0.2)
    ju, tu = js.update(dels, ins, variant=variant), ts.update(
        dels, ins, variant=variant)
    jr, tr = js.recompute(variant), ts.recompute(variant)
    assert np.array_equal(np.asarray(ju.ranks), np.asarray(jr.ranks))
    assert torch.equal(tu.ranks, tr.ranks) and torch.equal(ts.R, tr.ranks)
    assert tr.stats == tu.stats
    _step(jr, tr)


def test_replay_and_dt_errors_match_reference():
    jg = jgen.rmat(8, avg_degree=4, seed=2)
    js, ts = _open(jg)
    for sess in (js, ts):
        with pytest.raises(ValueError, match="no batch"):
            sess.recompute("df")
        sess.warmup()       # its empty batch is not "the last update"
        with pytest.raises(ValueError, match="no batch"):
            sess.recompute("dt")
    push = TSession.from_graph(THostGraph(jg.n, jg.edges), config=TConfig(
        block_size=B, tau=TAU, driver="push"), device="cpu")
    dels, ins = jdelta.random_batch(jg, 1e-2, seed=8)
    with pytest.raises(ValueError, match="dt reachability"):
        push.update(dels, ins, variant="dt")
    push.update(dels, ins)
    for variant in ("df", "dt"):
        with pytest.raises(ValueError, match="static' or 'nd"):
            push.recompute(variant)
