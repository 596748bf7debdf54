"""Twins of the walk properties W1 and W2 of ``tests/test_properties.py``:
the port's walk store and the JAX package's, built from the same
hypothesis-drawn graphs and batches, stay array-equal (walks, counts,
adjacency, degrees) with equal ``WalkUpdateStats``, and the port's holds
each property itself.

W1: a delta applied through delta-localized regeneration leaves the walk
buffers and visit counters bit-identical to regenerating every walk on the
updated graph.  W2: deleting and reinserting the same edges restores them.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.delta import random_batch
from repro.core.graph import HostGraph as JHostGraph
from repro.core.incremental import effective_batch
from repro.core.walk_engine import WalkState as JWalkState
from repro_torch.core.graph import HostGraph
from repro_torch.core.walk_engine import WalkState

CPU = "cpu"
NONE = np.zeros((0, 2), np.int64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stores(jh, th, **kw):
    return JWalkState(jh, **kw), WalkState(th, device=CPU, **kw)


def _same_store(jw, tw) -> None:
    for name in ("walks", "counts", "adj", "deg"):
        assert np.array_equal(np.asarray(getattr(jw, name)),
                              getattr(tw, name).numpy()), name


def _stats(s) -> dict:
    return dict(vars(s))


SET = settings(max_examples=15, deadline=None)


def _loopless(n: int, m: int, seed: int):
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)], 1)
    e = JHostGraph(n, e).edges
    e = e[e[:, 0] != e[:, 1]]
    return JHostGraph(n, e), HostGraph(n, e)


@SET
@given(st.integers(12, 48), st.integers(12, 96), st.integers(0, 2 ** 16))
def test_walk_delta_equals_full_regeneration(n, m, seed):
    jh, th = _loopless(n, m, seed)
    dels, ins = random_batch(jh, 0.2, seed=seed + 1)
    keep = np.asarray(ins)[:, 0] != np.asarray(ins)[:, 1]
    ins = np.asarray(ins)[keep]
    jw, tw = _stores(jh, th, R=4, L=12, seed=7)
    de, ie = effective_batch(jh, dels, ins)
    assert _stats(jw.apply_batch(de, ie)) == \
        _stats(tw.apply_batch(de, ie))
    full = WalkState(th.apply_batch(dels, ins), R=4, L=12, seed=7,
                     device=CPU)
    assert torch.equal(tw.walks, full.walks)
    assert torch.equal(tw.counts, full.counts)
    _same_store(jw, tw)


@SET
@given(st.integers(12, 48), st.integers(12, 96), st.integers(0, 2 ** 16))
def test_walk_delete_reinsert_noop(n, seed_m, seed):
    jh, th = _loopless(n, seed_m, seed)
    if th.m == 0:
        return
    rng = np.random.default_rng(seed)
    edges = th.edges[rng.choice(th.m, min(4, th.m), replace=False)]
    jw, tw = _stores(jh, th, R=4, L=12, seed=11)
    walks0, counts0 = tw.walks.clone(), tw.counts.clone()
    for ws in (jw, tw):
        ws.apply_batch(*effective_batch(jh, edges, NONE))
    _same_store(jw, tw)
    hg2 = jh.apply_batch(edges, NONE)
    for ws in (jw, tw):
        ws.apply_batch(*effective_batch(hg2, NONE, edges))
    assert torch.equal(tw.walks, walks0)
    assert torch.equal(tw.counts, counts0)
    _same_store(jw, tw)
