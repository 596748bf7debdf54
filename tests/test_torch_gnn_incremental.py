"""The port's DF-incremental GNN update (``repro_torch.core.incremental``:
``edge_update_sources``, ``out_neighbors_or``, ``incremental_gnn_update``,
``full_gnn_layers``) against the JAX package's, in one process on the CPU.

Twins of
``tests/test_ckpt_and_substrate.py::test_incremental_gnn_matches_full`` and
``tests/test_models.py::test_incremental_gnn_work_scales_with_update`` run
both packages on the same graph, batches and params (the JAX params
carried over with ``gnn_params_from_numpy``): the τ_f = 0 update equals a
full recompute within the reference test's rtol 1e-5, atol 1e-6 (f32), the
outputs and refreshed caches equal the reference's at that tolerance, and
``stats["recomputed"]`` and ``stats["total"]`` EQUAL the reference's at
τ_f = 0 and 1e-3 (the port's added ``stats["affected"]`` sums to
``recomputed``).  Over the seeds and batches here no node's change lies
within f32 rounding of τ_f, so the gates agree node for node; the test
reports the margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import incremental as jinc
from repro.models.gnn import GraphBatch as JGraphBatch
from repro.models.gnn import graphsage as jgs
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.core import incremental as tinc
from repro_torch.models.gnn import FAMILIES, GraphBatch
from repro_torch.models.gnn import graphsage as tgs

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """The same graphsage model and graph in both packages, with each
    package's layer closures and full-pass cache."""

    def __init__(self, n, e, d_feat, n_out, seed=0):
        self.cfg = get_arch("graphsage-reddit").build_cfg(d_feat=d_feat,
                                                          n_out=n_out)
        jcfg = j_get_arch("graphsage-reddit").build_cfg(d_feat=d_feat,
                                                        n_out=n_out)
        assert dataclasses.asdict(self.cfg) == dataclasses.asdict(jcfg)
        self.rng = np.random.default_rng(seed)
        self.n, self.e = n, e
        self.nodes = self.rng.normal(size=(n, d_feat)).astype(np.float32)
        self.snd = self.rng.integers(0, n, e)
        self.rcv = self.rng.integers(0, n, e)
        jp = jgs.init(jcfg, jax.random.PRNGKey(0))
        tp = gnn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device=CPU)
        self.jfns = jinc.full_gnn_layers(jgs, jp, jcfg)
        self.tfns = tinc.full_gnn_layers(tgs, tp, self.cfg)
        self.jh0 = jnp.asarray(self.nodes)
        self.th0 = torch.from_numpy(self.nodes)
        jg, tg = self.graphs()
        self.jcache, self.tcache = self.full(jg, tg)

    def graphs(self):
        return (JGraphBatch(nodes=self.jh0,
                            senders=jnp.asarray(self.snd, jnp.int32),
                            receivers=jnp.asarray(self.rcv, jnp.int32)),
                GraphBatch(nodes=self.th0,
                           senders=torch.from_numpy(self.snd.astype(np.int32)),
                           receivers=torch.from_numpy(
                               self.rcv.astype(np.int32))))

    def full(self, jg, tg):
        jc, tc = [self.jh0], [self.th0]
        for jf, tf in zip(self.jfns, self.tfns):
            jc.append(jf(jg, jc[-1]))
            tc.append(tf(tg, tc[-1]))
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        return jc, tc

    def rewire(self, k):
        """Rewire k random edges in place; returns (old, new) endpoint
        pairs, as the reference test does."""
        idx = self.rng.integers(0, self.e, k)
        old = np.stack([self.snd[idx], self.rcv[idx]], 1)
        self.snd[idx] = self.rng.integers(0, self.n, k)
        self.rcv[idx] = self.rng.integers(0, self.n, k)
        return old, np.stack([self.snd[idx], self.rcv[idx]], 1)

    def update(self, jg, tg, dels, ins, tau_f):
        """Both packages' update; their outputs, caches and counters
        compared.  Returns the port's (h, cache, stats)."""
        js = jinc.edge_update_sources(self.n, dels, ins)
        ts = tinc.edge_update_sources(self.n, dels, ins, device=CPU)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jh, jcache, jstats = jinc.incremental_gnn_update(
            self.jfns, jg, self.jh0, self.jcache, js, tau_f=tau_f)
        th, tcache, tstats = tinc.incremental_gnn_update(
            self.tfns, tg, self.th0, self.tcache, ts, tau_f=tau_f)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                                   atol=ATOL)
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        assert {k: tstats[k] for k in jstats} == jstats, (tstats, jstats)
        assert sum(tstats["affected"]) == tstats["recomputed"]
        assert len(tstats["affected"]) == self.cfg.n_layers
        return th, tcache, tstats


def test_incremental_gnn_matches_full():
    """Twin of
    tests/test_ckpt_and_substrate.py::test_incremental_gnn_matches_full."""
    p = Pair(512, 2048, 16, 4)
    old, new = p.rewire(4)
    jg2, tg2 = p.graphs()
    # τ_f = 0 ⇒ no cutoff ⇒ incremental must EXACTLY equal full recompute
    h_inc, _, stats = p.update(jg2, tg2, old, new, 0.0)
    h_full = p.th0
    for fn in p.tfns:
        h_full = fn(tg2, h_full)
    np.testing.assert_allclose(h_inc.numpy(), h_full.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert stats["recomputed"] < stats["total"], "frontier did not prune"


def test_incremental_gnn_work_scales_with_update():
    """Twin of
    tests/test_models.py::test_incremental_gnn_work_scales_with_update."""
    p = Pair(2048, 6144, 8, 4)
    jg, tg = p.graphs()
    fracs = []
    for k in (2, 64):
        idx = p.rng.integers(0, p.e, k)
        old = np.stack([p.snd[idx], p.rcv[idx]], 1)
        _, _, stats = p.update(jg, tg, old, old, 1e-3)
        fracs.append(stats["recomputed"] / stats["total"])
    assert fracs[0] < fracs[1] < 1.0, fracs
    assert fracs[0] < 0.25, f"small update recomputed {fracs[0]:.0%}"


@pytest.mark.parametrize("tau_f", [0.0, 1e-3])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_stats_equal_the_reference(k, tau_f):
    """Counters equal the reference's over a stream of three rewiring
    batches, each from the full pass of the graph before it; the margin of
    the nearest node to the τ_f gate is above f32 rounding."""
    p = Pair(1024, 4096, 12, 3, seed=k)
    for _ in range(3):
        old, new = p.rewire(k)
        jg, tg = p.graphs()
        prev = p.tcache
        _, tcache, stats = p.update(jg, tg, old, new, tau_f)
        assert 0 < stats["recomputed"] < stats["total"]
        if tau_f > 0:
            for a, b in zip(tcache[1:], prev[1:]):
                d = (a - b).abs().amax(dim=-1)
                margin = float((d - tau_f).abs().min())
                assert margin > 1e-6, margin
        jg, tg = p.graphs()
        p.jcache, p.tcache = p.full(jg, tg)


def test_out_neighbors_or_and_sources_match_jax():
    rng = np.random.default_rng(3)
    n, e = 50, 200
    snd, rcv = rng.integers(0, n + 1, e), rng.integers(0, n + 1, e)  # n: pad
    flags = rng.random(n) < 0.2
    jg = JGraphBatch(nodes=jnp.zeros((n, 1)), senders=jnp.asarray(snd),
                     receivers=jnp.asarray(rcv))
    tg = GraphBatch(nodes=torch.zeros(n, 1), senders=torch.from_numpy(snd),
                    receivers=torch.from_numpy(rcv))
    got = tinc.out_neighbors_or(tg, torch.from_numpy(flags))
    assert got.dtype == torch.bool and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jinc.out_neighbors_or(jg, jnp.asarray(flags))))
    dels = np.array([[0, 3], [n + 5, 2]])          # an id past n clamps
    ins = np.zeros((0, 2), np.int64)
    np.testing.assert_array_equal(
        tinc.edge_update_sources(n, dels, ins, device=CPU).numpy(),
        np.asarray(jinc.edge_update_sources(n, dels, ins)))


@pytest.mark.parametrize("family", ["gatedgcn", "egnn", "meshgraphnet"])
def test_full_gnn_layers_refuses_other_families(family):
    cfg = get_arch(family).smoke_cfg()
    with pytest.raises(NotImplementedError, match="graphsage"):
        tinc.full_gnn_layers(FAMILIES[family], {}, cfg)
