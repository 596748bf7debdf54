"""The port's neighbor sampler (``repro_torch.graphs.sampler``), data
pipeline (``repro_torch.data.pipeline``) and GNN config registry
(``repro_torch.configs``) against the JAX package's, on the CPU.

The sampler and every stream are array-equal to the reference's on fixed
seeds (the streams' tensors on ``device="cpu"``, with the reference's
dtypes); the ``ArchSpec`` and ``ShapeSpec`` fields of the ten ported
architectures (the LM and GNN ones and ``pagerank-df``), their configs,
``list_archs`` and ``iter_cells`` equal the reference's restricted to them; ``pagerank_df.engine_config`` gives the
reference's ``EngineConfig`` fields.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import pagerank_df as jpdf
from repro.core.graph import HostGraph as JHostGraph
from repro.data import pipeline as jpipe
from repro.graphs import sampler as jsampler
from repro_torch import configs as tconfigs
from repro_torch.configs import pagerank_df as tpdf
from repro_torch.core.graph import HostGraph
from repro_torch.data import pipeline as tpipe
from repro_torch.graphs import sampler as tsampler

CPU = "cpu"
PORTED = ("egnn", "gatedgcn", "granite-moe-3b-a800m", "graphsage-reddit",
          "meshgraphnet", "mixtral-8x22b", "nemotron-4-340b", "pagerank-df",
          "phi4-mini-3.8b", "qwen1.5-4b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(t, a):
    """A port tensor equals a reference array: values, shape and dtype."""
    a = np.asarray(a)
    assert isinstance(t, torch.Tensor) and t.device == torch.device(CPU)
    assert t.numpy().dtype == a.dtype, (t.dtype, a.dtype)
    np.testing.assert_array_equal(t.numpy(), a)


# ---------------------------------------------------------------------------
# the neighbor sampler
# ---------------------------------------------------------------------------

def _samplers(n=60, e=240, seed=0, isolated=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - isolated, e)       # the last ids: no out-edges
    dst = rng.integers(0, n, e)
    return (jsampler.NeighborSampler(n, src, dst),
            tsampler.NeighborSampler(n, src, dst))


@pytest.mark.parametrize("fanouts", [(3,), (4, 2), (25, 10), (2, 2, 3)])
def test_sample_block_matches_jax(fanouts):
    js, ts = _samplers()
    seeds = np.arange(60)                        # every node, isolated too
    a = js.sample_block(seeds, fanouts, np.random.default_rng(7))
    b = ts.sample_block(seeds, fanouts, np.random.default_rng(7))
    assert len(a) == len(b) == len(fanouts) + 1
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # isolated vertices sample themselves
    assert (b[1][-5:] == np.arange(55, 60)[:, None]).all()
    np.testing.assert_array_equal(js.degree(seeds), ts.degree(seeds))


def test_sampler_from_host_graph_and_minibatch_stream_match_jax():
    rng = np.random.default_rng(1)
    edges = rng.integers(0, 40, (200, 2))
    js = jsampler.NeighborSampler.from_host_graph(JHostGraph(40, edges))
    ts = tsampler.NeighborSampler.from_host_graph(HostGraph(40, edges))
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 40)
    ja = jsampler.minibatch_stream(js, feats, labels, 8, (3, 2), seed=4)
    tb = tsampler.minibatch_stream(ts, feats, labels, 8, (3, 2), seed=4)
    for (fa, la), (fb, lb) in itertools.islice(zip(ja, tb), 3):
        np.testing.assert_array_equal(la, lb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

def _streams_equal(ja, tb, k=3):
    for a, b in itertools.islice(zip(ja, tb), k):
        assert set(a) == set(b)
        for key in a:
            _same(b[key], a[key])


def test_lm_stream_matches_jax():
    _streams_equal(jpipe.lm_stream(101, 3, 9, seed=2, start=5),
                   tpipe.lm_stream(101, 3, 9, seed=2, start=5, device=CPU))


def test_recsys_stream_matches_jax():
    for fields in (1, 4):
        _streams_equal(jpipe.recsys_stream(fields, 50, 16, seed=3),
                       tpipe.recsys_stream(fields, 50, 16, seed=3,
                                           device=CPU))


@pytest.mark.parametrize("with_pos", [False, True])
def test_gnn_full_graph_batch_matches_jax(with_pos):
    kw = dict(n=50, e=300, d_feat=7, n_out=5, seed=9, with_pos=with_pos)
    a = jpipe.gnn_full_graph_batch(**kw)
    b = tpipe.gnn_full_graph_batch(device=CPU, **kw)
    assert set(a) == set(b)
    for key in a:
        _same(b[key], a[key])


def test_graphsage_minibatch_stream_matches_jax():
    js, ts = _samplers(seed=2)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(60, 4))             # f64: the stream casts
    labels = rng.integers(0, 3, 60)
    kw = dict(batch_nodes=8, fanouts=(3, 2), seed=6, start=2)
    _streams_equal(jpipe.graphsage_minibatch_stream(js, feats, labels, **kw),
                   tpipe.graphsage_minibatch_stream(ts, feats, labels,
                                                    device=CPU, **kw))


def test_counted_stream_and_prefetch_match_jax():
    make = lambda step: {"step": step}             # noqa: E731
    a = list(itertools.islice(jpipe.counted_stream(make, start=3), 4))
    b = list(itertools.islice(tpipe.counted_stream(make, start=3), 4))
    assert a == b == [{"step": s} for s in range(3, 7)]
    assert list(tpipe.prefetch(iter(range(20)), depth=3)) == list(range(20))
    assert list(tpipe.prefetch(iter([]))) == []


def test_dynamic_graph_stream_matches_jax():
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 64, (400, 2))
    ja = jpipe.dynamic_graph_stream(JHostGraph(64, edges), batch_frac=0.05,
                                    seed=3, deletions_frac=0.3)
    tb = tpipe.dynamic_graph_stream(HostGraph(64, edges), batch_frac=0.05,
                                    seed=3, deletions_frac=0.3)
    for (p0, p1, d0, i0), (q0, q1, d1, i1) in itertools.islice(zip(ja, tb),
                                                                 4):
        assert isinstance(q1, HostGraph)
        np.testing.assert_array_equal(q0.edges, p0.edges)
        np.testing.assert_array_equal(q1.edges, p1.edges)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)


def test_streams_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default places on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tpipe.lm_stream(10, 2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.gnn_full_graph_batch(n=4, e=4, d_feat=2, n_out=2)


# ---------------------------------------------------------------------------
# the config registry
# ---------------------------------------------------------------------------

def _fields(spec):
    """An ArchSpec's data fields, its configs as dicts, and its shapes with
    the sampler's module named package-neutrally."""
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
         if f.name not in ("build_cfg", "smoke_cfg", "shapes")}
    d["shapes"] = [dict(dataclasses.asdict(s),
                        note=s.note.replace("repro_torch.", "repro."))
                   for s in spec.shapes]
    for which in ("build_cfg", "smoke_cfg"):
        cfg = getattr(spec, which)()
        d[which] = (dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg)
                    else cfg)
    return d


def test_registry_lists_the_ported_archs():
    assert tconfigs.list_archs() == PORTED
    assert set(PORTED) <= set(jconfigs.list_archs())


@pytest.mark.parametrize("arch", PORTED)
def test_arch_specs_equal_the_reference(arch):
    t, j = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert isinstance(t, tconfigs.ArchSpec)
    assert _fields(t) == _fields(j)
    for s in t.shapes:
        assert t.shape(s.name) is s
        assert t.exec_for(s.name) == j.exec_for(s.name)
        for key, v in s.dims.items():
            assert s.dim(key) == v
    with pytest.raises(KeyError):
        t.shape("no-such-shape")
    if t.family == "gnn":
        kw = dict(d_feat=100, n_out=47, task="node_reg", n_layers=3)
        assert dataclasses.asdict(t.build_cfg(**kw)) == \
            dataclasses.asdict(j.build_cfg(**kw))


def test_iter_cells_equal_the_reference():
    for skipped in (False, True):
        want = [(a.arch_id, s.name) for a, s in
                jconfigs.iter_cells(include_skipped=skipped)
                if a.arch_id in PORTED]
        got = [(a.arch_id, s.name) for a, s in
               tconfigs.iter_cells(include_skipped=skipped)]
        assert got == want and got


def test_registry_errors():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("autoint")            # not ported yet
    from repro_torch.configs.registry import register
    with pytest.raises(ValueError, match="duplicate arch"):
        register(tconfigs.get_arch("egnn"))


@pytest.mark.parametrize("overrides", [{}, {"tau": 1e-7}, {"alpha": 0.9,
                                                           "tau_f_ratio": 0.1,
                                                           "dtype": "float64"},
                                       {"max_iterations": 50}])
def test_pagerank_df_engine_config_matches_jax(overrides):
    for cfg in (None, tpdf.smoke_cfg()):
        t = tpdf.engine_config(cfg, **overrides)
        j = jpdf.engine_config(None if cfg is None else jpdf.smoke_cfg(),
                               **overrides)
        for f in ("alpha", "tau", "tau_f", "block_size", "max_iterations",
                  "dtype"):
            assert getattr(t, f) == getattr(j, f), f
    with pytest.raises(TypeError, match="unknown EngineConfig key"):
        tpdf.engine_config(no_such_key=1)
    assert tpdf.build_cfg() == jpdf.build_cfg()
    assert tpdf.smoke_cfg() == jpdf.smoke_cfg()
