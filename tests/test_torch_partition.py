"""The port's partitioners and wire-compression primitives against the JAX
package's (``repro.graphs.partition``, ``repro.dist.compression``).

Partitioners are numpy on both sides: orders, inverses, owners, relabeled
edge sets and edge cuts must be ARRAY-EQUAL on the same seeded graphs.
The compression twins feed the same numpy inputs through both packages
and hold the port to the JAX tests' own bounds
(``tests/test_ckpt_and_substrate.py:70-99``) and to the JAX outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import HostGraph as JHostGraph
from repro.dist import compression as jcomp
from repro.graphs import generators as jgen
from repro.graphs import partition as jpart
from repro_torch.core.graph import HostGraph
from repro_torch.dist import compression as tcomp
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import partition as tpart


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAPHS = {
    "rmat10": lambda g: g.rmat(10, avg_degree=8, seed=0),
    "rmat10_s3": lambda g: g.rmat(10, avg_degree=6, seed=3),
    "road48": lambda g: g.grid_road(48, diag_frac=0.0, seed=0),
    "road32": lambda g: g.grid_road(32, seed=7),
}


def _graphs(name):
    jg = GRAPHS[name](jgen)
    tg = GRAPHS[name](tgen)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    return jg, tg


# -- twins of tests/test_ckpt_and_substrate.py:108 and :120 -------------------

def test_partitioners_cover_and_balance():
    hg = tgen.rmat(10, 8, seed=0)
    for fn in (lambda: tpart.contiguous(hg.n, 8),
               lambda: tpart.hashed(hg.n, 8),
               lambda: tpart.bfs_blocks(hg, 8)):
        owner = fn()
        assert owner.shape == (hg.n,)
        assert owner.min() >= 0 and owner.max() < 8
        counts = np.bincount(owner, minlength=8)
        assert counts.max() <= 2 * counts[counts > 0].mean()


def test_bfs_partition_cuts_fewer_edges_on_road():
    hg = tgen.grid_road(48, diag_frac=0.0, seed=0)
    cut_hash = tpart.edge_cut(hg, tpart.hashed(hg.n, 16))
    cut_bfs = tpart.edge_cut(hg, tpart.bfs_blocks(hg, 16))
    assert cut_bfs < cut_hash * 0.5, (cut_bfs, cut_hash)


# -- array-equal to the reference ---------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("kind", tpart.PARTITIONERS)
def test_make_partition_equals_reference(graph, n_dev, kind):
    jg, tg = _graphs(graph)
    jo, ji, jw = jpart.make_partition(jg, n_dev, kind)
    to, ti, tw = tpart.make_partition(tg, n_dev, kind)
    for a, b in ((to, jo), (ti, ji), (tw, jw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the requested owners' cut and the realized one (the runtime's
    # contiguous split of the relabeled space)
    n_loc = -(-tg.n // n_dev)
    for owner_t, owner_j in ((tw, jw), (ti // n_loc, ji // n_loc)):
        assert tpart.edge_cut(tg, owner_t) == jpart.edge_cut(jg, owner_j)
    t_rel, t_inv = tpart.relabel(tg, to)
    j_rel, j_inv = jpart.relabel(jg, jo)
    np.testing.assert_array_equal(t_inv, j_inv)
    np.testing.assert_array_equal(t_rel.edges, j_rel.edges)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bfs_order_and_hash_equal_reference(graph):
    jg, tg = _graphs(graph)
    np.testing.assert_array_equal(tpart.bfs_order(tg), jpart.bfs_order(jg))
    for n_dev, seed in ((8, 0x9E3779B9), (5, 12345)):
        np.testing.assert_array_equal(tpart.hashed(tg.n, n_dev, seed=seed),
                                      jpart.hashed(jg.n, n_dev, seed=seed))


def test_bfs_order_equals_reference_on_random_graphs():
    """The level-at-a-time BFS against the reference's vertex-at-a-time
    loop: isolated vertices, duplicate and two-way edges, many components."""
    rng = np.random.default_rng(26)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        e = rng.integers(0, n, (int(rng.integers(0, 4 * n + 1)), 2))
        np.testing.assert_array_equal(tpart.bfs_order(HostGraph(n, e)),
                                      jpart.bfs_order(JHostGraph(n, e)))


def test_partition_edge_cases_equal_reference():
    empty_t = HostGraph(5, np.zeros((0, 2)))
    empty_j = JHostGraph(5, np.zeros((0, 2)))
    owner = tpart.contiguous(5, 2)
    assert tpart.edge_cut(empty_t, owner) == jpart.edge_cut(empty_j, owner)
    np.testing.assert_array_equal(tpart.bfs_order(empty_t),
                                  jpart.bfs_order(empty_j))
    with pytest.raises(ValueError, match="unknown partitioner"):
        tpart.make_partition(empty_t, 2, "metis")
    with pytest.raises(ValueError, match="unknown partitioner"):
        jpart.make_partition(empty_j, 2, "metis")


# -- compression twins of tests/test_ckpt_and_substrate.py:70-99 --------------

def test_bf16_roundtrip_close():
    a = np.linspace(-2, 2, 64).reshape(8, 8).astype(np.float32)
    g = {"a": torch.from_numpy(a)}
    back = tcomp.bf16_decompress(tcomp.bf16_compress(g), g)
    assert back["a"].dtype == torch.float32
    assert float((back["a"] - g["a"]).abs().max()) < 2e-2
    jg = {"a": jnp.asarray(a)}
    jback = jcomp.bf16_decompress(jcomp.bf16_compress(jg), jg)
    np.testing.assert_array_equal(back["a"].numpy(), np.asarray(jback["a"]))


def test_topk_error_feedback_conserves_mass():
    """kept + residual == grad + prior residual, and the kept entries are
    the JAX version's."""
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (128,)))
    g = {"a": torch.from_numpy(a.copy())}
    ef = tcomp.ErrorFeedback.init(g)
    kept, ef2 = tcomp.topk_compress(g, ef, frac=0.1)
    total = kept["a"] + ef2.residual["a"]
    np.testing.assert_allclose(total.numpy(), a, rtol=1e-6)
    assert int((kept["a"] != 0).sum()) >= 12
    jgr = {"a": jnp.asarray(a)}
    jkept, jef = jcomp.topk_compress(jgr, jcomp.ErrorFeedback.init(jgr),
                                     frac=0.1)
    np.testing.assert_array_equal(kept["a"].numpy(), np.asarray(jkept["a"]))
    np.testing.assert_array_equal(ef2.residual["a"].numpy(),
                                  np.asarray(jef.residual["a"]))


def test_topk_residual_applied_next_round():
    g = {"a": torch.tensor([10.0, 1.0, 0.5, 0.1])}
    ef = tcomp.ErrorFeedback.init(g)
    kept1, ef = tcomp.topk_compress(g, ef, frac=0.25)   # keeps 10.0
    assert float(kept1["a"][0]) == 10.0
    zero = {"a": torch.zeros(4)}
    kept2, ef = tcomp.topk_compress(zero, ef, frac=0.25)  # residual resurfaces
    assert float(kept2["a"][1]) == 1.0


def test_topk_keeps_tree_structure():
    tree = {"w": [torch.arange(8.0), (torch.ones(3),)]}
    kept, ef = tcomp.topk_compress(tree, tcomp.ErrorFeedback.init(tree),
                                   frac=0.25)
    assert isinstance(kept["w"], list) and isinstance(kept["w"][1], tuple)
    assert kept["w"][0].tolist() == [0, 0, 0, 0, 0, 0, 6.0, 7.0]
    assert ef.residual["w"][0].tolist() == [0, 1, 2, 3, 4, 5, 0, 0]


def test_quantize_8bit_bounds():
    a = np.linspace(-3, 3, 100).astype(np.float32)
    q, s = tcomp.quantize_8bit(torch.from_numpy(a))
    back = tcomp.dequantize_8bit(q, s)
    assert q.dtype == torch.int8
    assert float((back - torch.from_numpy(a)).abs().max()) <= \
        float(s) * 0.5 + 1e-6
    jq, js = jcomp.quantize_8bit(jnp.asarray(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
