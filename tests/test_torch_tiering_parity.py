"""Whole tiered sessions of both packages on the same streams: the port's
(``device="cpu"``, the kernels' plain versions reading the packed slab)
against ``repro``'s (JAX on the CPU), at budgets 1.0, 0.5 and a tight
0.125 of the pool, from a tiered cold solve; and a twin of the smoke tier
of ``benchmarks/scale.py`` (``SMOKE_LADDER``, budgets 1.0 / 0.5, and 0.25
on the first row; the pull driver; the bench's f32 warm start and local
insertion batches, as ``_run_row`` drives them), with its push row (the
first row's graph, budget 0.5, ``driver="push"``) at the bench's f32 and
in f64.  ``benchmarks/`` is read, not ported.

In f64 every counter of the reference's ``report().tiering``, the sweeps
and the edges of every update are equal and the ranks agree to ≤ 1e-12.
At the reference's f32 setting the structural counters (slab, budget and
pool sizes) are always equal.  The counters that follow the stream are
equal at the full budget and within 1 % relative under eviction; the
sweeps and edges are within 1 % too (on the smoke ladder's warm start they
part by 0.13 % even at the full budget): XLA's and torch's f32 sums differ in the last
bit, and a sweep's max |Δr| that lies within an ulp of τ ends a drive in
one package and takes one more sweep in the other.  On the 0.125 stream
below this first happens in the first update's 36th refill round (the
reference's 86th drive): inputs 2 ulp apart, sweep 2's max |Δr| at one row
9.8953e-9 in the reference against 1.0012e-8 here (τ = 1e-8);
``test_f32_parting_is_a_tau_crossing`` holds this.  The largest difference
observed is 0.95 % (misses, 2,719 against 2,745).  The push row parts
further in f32 (``F32_PUSH_RTOL``); in f64 all of it is equal.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JConfig
from repro.api import PageRankSession as JSession
from repro.graphs.generators import grid_road
from repro_torch.api import EngineConfig as TConfig
from repro_torch.api import PageRankSession as TSession
from repro_torch.core import tiering
from repro_torch.core.graph import HostGraph as THostGraph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import scale  # noqa: E402

CPU = "cpu"
TAU = 1e-8
ABANDON_TOL = 1e-6          # tests/test_tiering.py: ~5.7 tau at f32
# f32 under eviction: the stream-following counters, sweeps and edges
# (see the module docstring; 0.95 % is the largest difference observed)
F32_EVICT_RTOL = 0.01
STRUCT_COUNTERS = ("slab_tiles", "slab_bytes", "budget_bytes", "pool_tiles",
                   "pool_bytes")
STREAM_COUNTERS = ("resident_blocks", "hits", "misses", "evictions",
                   "admitted_tiles", "transfer_bytes", "refill_drives",
                   "refill_stalls")
REF_COUNTERS = STRUCT_COUNTERS + STREAM_COUNTERS
# f32 push under eviction: the per-vertex |r| > τ test flips at vertices
# whose |r| lies within the residual's granularity of τ, and a flip changes
# which blocks the refill loop defers and admits, so on the smoke push row
# the parting compounds over the rounds: 10.5 % at most (update 4's sweeps,
# 179 against 200; misses 989 against 1,053).  This row's own stream is a
# case of tests/test_torch_tiering_push.py::
# test_f32_push_parting_is_a_tau_crossing: its first parting drive (the 3rd
# of 46) starts from p 1 ulp and r 2 ulp apart, and its 9th sweep pushes one
# vertex in one package only, |r| = 1.00021e-8 against 9.97796e-9 (τ = 1e-8)
F32_PUSH_RTOL = 0.15


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_bytes(hg, dtype):
    g0 = THostGraph(hg.n, hg.edges).snapshot(block_size=64, device=CPU)
    src, dst = g0.in_edges_host()
    return int(tiering.HostTilePool.from_edges(
        dst, src, g0.n_pad, g0.n_pad, block=64, dtype=dtype).nbytes)


def _local_stream(n, batches, k=16, seed=11, window=1024):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        base = int(rng.integers(0, max(n - window, 1)))
        ins = base + rng.integers(0, min(window, n), (k, 2))
        out.append((np.zeros((0, 2), np.int64), ins))
    return out


def _run(cls, hg, stream, *, dtype, budget, r0=None, driver="pull"):
    """Open one package's tiered session, warm it up and stream."""
    kw = dict(engine="pallas", tau=TAU, block_size=64, dtype=dtype,
              device_budget_bytes=budget, driver=driver)
    if cls is JSession:
        sess = JSession.from_graph(hg, config=JConfig(**kw), r0=r0)
    else:
        sess = TSession.from_graph(THostGraph(hg.n, hg.edges),
                                   config=TConfig(**kw), r0=r0, device=CPU)
    sess.warmup()
    return sess, [sess.update(d, i) for d, i in stream]


def _both(hg, stream, **kw):
    return (*_run(JSession, hg, stream, **kw),
            *_run(TSession, hg, stream, **kw))


def _assert_close_counters(tc, jc):
    for k in STRUCT_COUNTERS:
        assert tc[k] == jc[k], k
    for k in STREAM_COUNTERS:
        assert tc[k] == pytest.approx(jc[k], rel=F32_EVICT_RTOL), k


def _work(results):
    return np.array([[r.stats.sweeps, r.stats.edges_processed]
                     for r in results])


def _counters(sess):
    t = sess.report().tiering
    return {k: t[k] for k in REF_COUNTERS}


@pytest.mark.parametrize("dtype,frac", [
    ("float64", 1.0), ("float64", 0.5), ("float64", 0.125),
    ("float32", 1.0), ("float32", 0.5), ("float32", 0.125)])
def test_tiered_session_matches_reference(dtype, frac):
    hg = grid_road(32, seed=7)
    stream = _local_stream(hg.n, 3)
    budget = max(int(_pool_bytes(hg, np.dtype(dtype)) * frac), 1)
    js, jr, ts, tr = _both(hg, stream, dtype=dtype, budget=budget)
    assert all(r.converged for r in tr) and all(r.converged for r in jr)
    jc, tc = _counters(js), _counters(ts)
    got, want = _work(tr), _work(jr)
    linf = float(np.abs(ts.ranks - np.asarray(js.ranks)).max())
    if dtype == "float64" or frac == 1.0:
        assert tc == jc
        np.testing.assert_array_equal(got, want)
    else:
        _assert_close_counters(tc, jc)
        np.testing.assert_allclose(got, want, rtol=F32_EVICT_RTOL)
    assert linf <= (1e-12 if dtype == "float64" else ABANDON_TOL), linf
    if frac < 1.0:
        assert tc["evictions"] > 0 and tc["refill_drives"] > 0
    assert ts.hot.scrub() == []
    js.close(), ts.close()


class _Stop(Exception):
    pass


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def test_f32_parting_is_a_tau_crossing(monkeypatch):
    """Where the f32 sessions part under eviction, the cause is a sweep's
    max |Δr| within an ulp of τ, not the tiering logic: at the first drive
    whose sweeps, edges or deferral set differ, the inputs agree to a few
    ulp, and the sweep that ends one package's drive has max |Δr| ≤ τ
    while the same sweep in the other package is over τ by an ulp."""
    hg = grid_road(32, seed=7)
    stream = _local_stream(hg.n, 3)
    budget = max(int(_pool_bytes(hg, np.float32) * 0.125), 1)
    logs = {JSession: [], TSession: []}
    probe = {}

    def hook(cls):
        orig = cls._drive

        def drive(self, R0, affected, **kw):
            k = len(logs[cls])
            if probe.get("at") == k:      # max |Δr| of each of the sweeps
                cfg, prev, deltas = self.config, _host(R0), []
                for m in range(1, probe["sweeps"] + 1):
                    object.__setattr__(self, "config", dataclasses.replace(
                        cfg, max_iterations=m))
                    cur = _host(orig(self, R0, affected, **kw)[0])
                    deltas.append(float(np.abs(
                        cur[:hg.n].astype(np.float64) - prev[:hg.n]).max()))
                    prev = cur
                object.__setattr__(self, "config", cfg)
                probe[cls] = (_host(R0)[:hg.n].astype(np.float64), deltas)
                raise _Stop
            out = orig(self, R0, affected, **kw)
            logs[cls].append((out[1].sweeps, out[1].edges_processed,
                              self._deferred_rb.tobytes()))
            return out
        monkeypatch.setattr(cls, "_drive", drive)

    for cls in logs:
        hook(cls)
        _run(cls, hg, stream, dtype="float32", budget=budget)
    k = next(i for i, (a, b) in enumerate(zip(*logs.values())) if a != b)
    (js_, _, _), (ts_, _, _) = logs[JSession][k], logs[TSession][k]
    assert js_ != ts_                     # the drives part by a sweep
    probe.update(at=k, sweeps=max(js_, ts_))
    for cls in logs:
        logs[cls].clear()
        with pytest.raises(_Stop):
            _run(cls, hg, stream, dtype="float32", budget=budget)
    (jr0, jd), (tr0, td) = probe[JSession], probe[TSession]
    ulp = float(np.spacing(np.float32(jr0.max())))
    assert float(np.abs(jr0 - tr0).max()) <= 4 * ulp
    last = min(js_, ts_) - 1              # the sweep that ends the shorter
    short, long_ = (jd, td) if js_ < ts_ else (td, jd)
    assert short[last] <= TAU < long_[last]
    assert long_[last] - short[last] <= 2 * ulp


_ROWS = [(i, side, frac)
         for i, (side, *_rest) in enumerate(scale.SMOKE_LADDER)
         for frac in scale.BUDGET_FRACS
         + ((scale.SMOKE_EXTRA_FRAC,) if i == 0 else ())]


@pytest.mark.parametrize("row,side,frac", _ROWS)
def test_scale_smoke_ladder_matches_reference(row, side, frac):
    """One row of ``benchmarks/scale.py --smoke`` (pull driver) through
    both packages: ``_run_row``'s budget, warm start and batches."""
    _, tau, batches, batch_edges = scale.SMOKE_LADDER[row]
    assert tau == TAU
    hg = grid_road(side, seed=7)
    budget = max(int(_pool_bytes(hg, np.float32) * frac), 1)
    r0 = scale._reference_ranks(hg)
    rng = np.random.default_rng(11 + row)
    stream = [(np.zeros((0, 2), np.int64),
               scale._local_batch(rng, hg.n, batch_edges))
              for _ in range(batches)]
    js, jr, ts, tr = _both(hg, stream, dtype="float32", budget=budget,
                           r0=r0)
    assert all(r.converged for r in tr) and all(r.converged for r in jr)
    if frac == 1.0:
        assert _counters(ts) == _counters(js)
    else:
        _assert_close_counters(_counters(ts), _counters(js))
    np.testing.assert_allclose(_work(tr), _work(jr), rtol=F32_EVICT_RTOL)
    assert float(np.abs(ts.ranks - np.asarray(js.ranks)).max()) \
        <= ABANDON_TOL
    js.close(), ts.close()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scale_smoke_push_row_matches_reference(dtype):
    """The push row of ``benchmarks/scale.py --smoke`` (grid_road of the
    first ladder row, budget 0.5, ``driver="push"``, ``_run_row``'s warm
    start and batches) through both packages: at the bench's f32 and, with
    every counter equal, in f64."""
    side, tau, batches, batch_edges = scale.SMOKE_LADDER[0]
    assert tau == TAU
    hg = grid_road(side, seed=7)
    budget = max(int(_pool_bytes(hg, np.dtype(dtype)) * 0.5), 1)
    rng = np.random.default_rng(11)
    stream = [(np.zeros((0, 2), np.int64),
               scale._local_batch(rng, hg.n, batch_edges))
              for _ in range(batches)]
    r0 = scale._reference_ranks(hg).astype(dtype)
    js, jr, ts, tr = _both(hg, stream, dtype=dtype, budget=budget, r0=r0,
                           driver="push")
    assert all(r.converged for r in tr) and all(r.converged for r in jr)
    tc, jc = _counters(ts), _counters(js)
    linf = float(np.abs(ts.ranks - np.asarray(js.ranks)).max())
    if dtype == "float64":
        assert tc == jc
        np.testing.assert_array_equal(_work(tr), _work(jr))
        assert [r.pushed_blocks for r in tr] == [r.pushed_blocks for r in jr]
        assert linf <= 1e-12, linf
    else:
        for k in STRUCT_COUNTERS:
            assert tc[k] == jc[k], k
        for k in STREAM_COUNTERS:
            assert tc[k] == pytest.approx(jc[k], rel=F32_PUSH_RTOL), k
        np.testing.assert_allclose(_work(tr), _work(jr), rtol=F32_PUSH_RTOL)
        assert linf <= ABANDON_TOL, linf
    js.close(), ts.close()
