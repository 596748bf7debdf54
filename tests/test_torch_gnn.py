"""The port's GNN model zoo (``repro_torch.models.gnn``) against the JAX
package's (``repro.models.gnn``), in one process on the CPU.

Each family's params come from the JAX ``init`` and are carried over with
``repro_torch.convert.gnn_params_from_numpy``; inputs are made from a numpy
seed.  ``forward`` and ``loss_fn`` of every family at its ``smoke_cfg``
agree with the reference within rtol 1e-5, atol 1e-6 in f32 (different
summation orders; EGNN atol 5e-6: its outputs reach ~15 and the measured
gap is 2.9e-6, where the reference's own f32 result is 1.5e-6 off its f64
one), and within rtol 1e-10, atol 1e-12 with params and inputs in f64
(the losses, f32 in both packages, at the f32 tolerance), on a plain
graph, a padded and masked one (phantom edges at ``n_pad``), batched small
graphs with ``task="graph_reg"`` and a graph with edge features; so do
GraphSAGE's ``forward_sampled`` and
``loss_fn_sampled``, the message-passing primitives, and twins of
``tests/test_models.py::test_egnn_is_e3_equivariant`` and
``::test_gnn_node_permutation_equivariance``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import gnn as jgnn
from repro.models.gnn import common as JC
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.models import gnn as tgnn
from repro_torch.models.gnn import common as TC

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
FAMILY_ATOL = {"egnn": 5e-6}     # f32; see the module docstring
ARCHS = ("graphsage-reddit", "gatedgcn", "egnn", "meshgraphnet")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (see tests/test_torch_push.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(jmod, cfg, seed=0):
    """The JAX family's params and the port's copy of them."""
    jp = jmod.init(cfg, jax.random.PRNGKey(seed))
    tp = gnn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                               device=CPU)
    return jp, tp


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _graph(kind: str, cfg, seed: int = 0) -> dict:
    """numpy arrays of one GraphBatch and its labels.  ``kind``: "plain",
    "padded" (last 3 nodes and 20 edges masked, the masked edges pointing
    at the phantom node n_pad), "graph_reg" (8 graphs of 6 nodes and 12
    edges, offsets per graph), "edge_feat" (2 edge features)."""
    rng = np.random.default_rng(seed)
    if kind == "graph_reg":
        n_g, n_per, e_per = 8, 6, 12
        n, e = n_g * n_per, n_g * e_per
        off = np.repeat(np.arange(n_g) * n_per, e_per)
        snd = rng.integers(0, n_per, e) + off
        rcv = rng.integers(0, n_per, e) + off
        gid = np.repeat(np.arange(n_g), n_per).astype(np.int32)
    else:
        n, e = 24, 96
        snd, rcv = rng.integers(0, n, e), rng.integers(0, n, e)
        gid, n_g = None, 1
    out = {"nodes": rng.normal(size=(n, cfg.d_feat)).astype(np.float32),
           "senders": snd.astype(np.int32), "receivers": rcv.astype(np.int32),
           "pos": rng.normal(size=(n, 3)).astype(np.float32),
           "graph_id": gid, "n_graphs": n_g}
    if kind == "padded":
        emask = np.ones(e, bool)
        emask[-20:] = False
        out["senders"][-20:] = n
        out["receivers"][-20:] = n
        nmask = np.ones(n, bool)
        nmask[-3:] = False
        out["edge_mask"], out["node_mask"] = emask, nmask
    if kind == "edge_feat":
        out["edge_feat"] = rng.normal(size=(e, 2)).astype(np.float32)
    if cfg.task == "node_clf":
        out["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
    elif cfg.task == "graph_reg":
        out["labels"] = rng.normal(size=(n_g, cfg.n_out)).astype(np.float32)
    else:
        out["labels"] = rng.normal(size=(n, cfg.n_out)).astype(np.float32)
    return out


def _batches(arrs: dict, *, pos: bool):
    """The same graph as a JAX GraphBatch and as the port's (CPU)."""
    fields = ("nodes", "senders", "receivers", "edge_feat", "graph_id",
              "node_mask", "edge_mask") + (("pos",) if pos else ())
    jkw = {k: jnp.asarray(arrs[k]) for k in fields if arrs.get(k) is not None}
    tkw = {k: torch.from_numpy(arrs[k]) for k in fields
           if arrs.get(k) is not None}
    return (JC.GraphBatch(n_graphs=arrs["n_graphs"], **jkw),
            TC.GraphBatch(n_graphs=arrs["n_graphs"], **tkw))


def _cfg(arch: str, kind: str):
    cfg = get_arch(arch).smoke_cfg()
    if kind == "graph_reg":
        cfg = dataclasses.replace(cfg, task="graph_reg", n_out=1)
    if kind == "edge_feat":
        cfg = dataclasses.replace(cfg, d_edge_feat=2)
    return cfg


# ---------------------------------------------------------------------------
# every family: forward and loss against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["plain", "padded", "graph_reg",
                                  "edge_feat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_and_loss_match_jax(arch, kind, dtype):
    cfg = dataclasses.replace(_cfg(arch, kind), dtype=dtype)
    jmod, tmod = jgnn.get_family(cfg), tgnn.get_family(cfg)
    assert tmod.__name__.split(".")[-1] == jmod.__name__.split(".")[-1]
    jp, tp = _params(jmod, cfg)
    arrs = _graph(kind, cfg, seed=len(arch) + len(kind))
    for k in ("nodes", "pos", "edge_feat"):
        if arrs.get(k) is not None:
            arrs[k] = arrs[k].astype(dtype)
    if cfg.task != "node_clf":
        arrs["labels"] = arrs["labels"].astype(dtype)
    tol = (dict(rtol=RTOL, atol=FAMILY_ATOL.get(cfg.family, ATOL))
           if dtype == "float32" else dict(rtol=1e-10, atol=1e-12))
    jg, tg = _batches(arrs, pos=cfg.family in ("egnn", "meshgraphnet"))
    jout, tout = jmod.forward(jp, cfg, jg), tmod.forward(tp, cfg, tg)
    if cfg.family == "egnn":
        _close(tout[1], jout[1], **tol)         # the final positions
        jout, tout = jout[0], tout[0]
    assert tuple(tout.shape) == jout.shape
    assert tout.dtype == getattr(torch, dtype)
    _close(tout, jout, **tol)
    jl, jaux = jmod.loss_fn(jp, cfg, jg, jnp.asarray(arrs["labels"]))
    tl, taux = tmod.loss_fn(tp, cfg, tg, torch.from_numpy(arrs["labels"]))
    assert tl.shape == () and set(taux) == set(jaux) == {"loss"}
    _close(tl, jl)          # both packages compute the loss in f32


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_equal_the_reference(arch):
    """Every family's parameter names and shapes at its published widths,
    and the rules of ``init_from_shapes`` (ones for norms, zeros for
    biases, normal · fan_in^-½ from a seeded CPU generator)."""
    cfg, jcfg = get_arch(arch).build_cfg(), j_get_arch(arch).build_cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tmod, jmod = tgnn.get_family(cfg), jgnn.get_family(jcfg)
    assert tmod.shapes(cfg) == jmod.shapes(jcfg)
    scfg = get_arch(arch).smoke_cfg()
    p1, p2 = tmod.init(scfg, 3, device=CPU), tmod.init(scfg, 3, device=CPU)
    p3 = tmod.init(scfg, torch.Generator().manual_seed(4), device=CPU)
    for name, shape in tmod.shapes(scfg).items():
        leaf = name.split("/")[-1]
        t = p1[name]
        assert tuple(t.shape) == shape and t.dtype == torch.float32
        assert torch.equal(t, p2[name])
        if "norm" in leaf or leaf.startswith("ln"):
            assert torch.all(t == 1)
        elif TC._is_bias(leaf):
            assert torch.all(t == 0)
        else:
            assert not torch.equal(t, p3[name])
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            assert abs(float(t.std()) * fan_in ** 0.5 - 1) < 0.35


def test_init_rules_match_the_reference_leaf_classes():
    names = ["ln_h", "layers/ln_e", "norm", "b", "b0", "e_b1", "bias_x",
             "bn_w", "w_self", "e_w0", "dec/b", "enc/b_node", "x_w1"]
    for leaf in names:
        assert TC._is_bias(leaf.split("/")[-1]) == \
            JC._is_bias(leaf.split("/")[-1]), leaf


# ---------------------------------------------------------------------------
# GraphSAGE's sampled minibatch path
# ---------------------------------------------------------------------------

def test_graphsage_sampled_forward_and_loss_match_jax():
    from repro.models.gnn import graphsage as jgs
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models.gnn import graphsage as tgs
    cfg = get_arch("graphsage-reddit").smoke_cfg()
    jp, tp = _params(jgs, cfg, seed=1)
    rng = np.random.default_rng(5)
    n, e = 40, 160
    feats = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_out, n).astype(np.int32)
    sampler = NeighborSampler(n, rng.integers(0, n, e), rng.integers(0, n, e))
    seeds = rng.integers(0, n, 16)
    hops = sampler.sample_block(seeds, cfg.sample_sizes, rng)
    assert [h.shape for h in hops] == [(16,), (16, 3), (16, 3, 2)]
    jf = [jnp.asarray(feats[h]) for h in hops]
    tf = [torch.from_numpy(feats[h]) for h in hops]
    _close(tgs.forward_sampled(tp, cfg, tf), jgs.forward_sampled(jp, cfg, jf))
    jl, _ = jgs.loss_fn_sampled(jp, cfg, jf, jnp.asarray(labels[seeds]))
    tl, aux = tgs.loss_fn_sampled(tp, cfg, tf,
                                  torch.from_numpy(labels[seeds]))
    _close(tl, jl)
    assert aux["loss"] is tl


# ---------------------------------------------------------------------------
# message-passing primitives
# ---------------------------------------------------------------------------

def _masked_pair(d=5, seed=9):
    rng = np.random.default_rng(seed)
    n, e = 12, 40
    arrs = {"nodes": rng.normal(size=(n, d)).astype(np.float32),
            "senders": rng.integers(0, n, e).astype(np.int32),
            "receivers": rng.integers(0, n - 2, e).astype(np.int32),
            "graph_id": np.repeat(np.arange(3), 4).astype(np.int32),
            "n_graphs": 3}
    arrs["receivers"][-6:] = n              # phantom edges
    emask = np.ones(e, bool)
    emask[-6:] = False
    emask[:3] = False
    arrs["edge_mask"] = emask
    nmask = np.ones(n, bool)
    nmask[5] = False
    arrs["node_mask"] = nmask
    return arrs, _batches(arrs, pos=False), rng


def test_message_passing_primitives_match_jax():
    arrs, (jg, tg), rng = _masked_pair()
    msg = rng.normal(size=(40, 5)).astype(np.float32)
    jm, tm = jnp.asarray(msg), torch.from_numpy(msg)
    h = arrs["nodes"]
    _close(TC.gather_src(tg, torch.from_numpy(h)),
           JC.gather_src(jg, jnp.asarray(h)), rtol=0, atol=0)
    _close(TC.gather_dst(tg, torch.from_numpy(h)),
           JC.gather_dst(jg, jnp.asarray(h)), rtol=0, atol=0)
    for fn in ("scatter_sum", "scatter_mean", "scatter_max"):
        _close(getattr(TC, fn)(tg, tm), getattr(JC, fn)(jg, jm))
    for op in ("mean", "sum"):
        _close(TC.graph_readout(tg, torch.from_numpy(h), op=op),
               JC.graph_readout(jg, jnp.asarray(h), op=op))
    lg = rng.normal(size=(12, 4)).astype(np.float32)
    lab = rng.integers(-1, 4, 12).astype(np.int32)   # −1: unlabelled
    mask = arrs["node_mask"].astype(np.float32)
    _close(TC.node_xent(torch.from_numpy(lg), torch.from_numpy(lab),
                        torch.from_numpy(mask)),
           JC.node_xent(jnp.asarray(lg), jnp.asarray(lab), jnp.asarray(mask)))
    tgt = rng.normal(size=(12, 4)).astype(np.float32)
    for m in (None, mask):
        _close(TC.mse(torch.from_numpy(lg), torch.from_numpy(tgt),
                      None if m is None else torch.from_numpy(m)),
               JC.mse(jnp.asarray(lg), jnp.asarray(tgt),
                      None if m is None else jnp.asarray(m)))
    p = {k: rng.normal(size=s).astype(np.float32)
         for k, s in TC.mlp_shapes(5, 7, 3, 3).items()}
    for ln in (False, True):
        _close(TC.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(h), n_layers=3, layernorm=ln),
               JC.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(h), n_layers=3, layernorm=ln))


def test_scatter_max_pins_empty_bins_and_negative_maxima():
    """Bins with no message come out 0 (−inf clamped), and so do bins whose
    maximum is negative: the reference's clamp at 0, kept on purpose."""
    snd = np.array([0, 1, 2, 3, 4, 5], np.int32)
    rcv = np.array([0, 0, 2, 2, 4, 5], np.int32)    # bins 1 and 3 empty
    msg = np.array([[-3.0, 2.0], [-1.0, -5.0], [4.0, -2.0], [1.0, 3.0],
                    [-0.5, -0.25], [0.0, 7.0]], np.float32)
    arrs = {"nodes": np.zeros((6, 2), np.float32), "senders": snd,
            "receivers": rcv, "n_graphs": 1}
    jg, tg = _batches(arrs, pos=False)
    got = TC.scatter_max(tg, torch.from_numpy(msg))
    want = np.array([[0.0, 2.0], [0.0, 0.0], [4.0, 3.0], [0.0, 0.0],
                     [0.0, 0.0], [0.0, 7.0]], np.float32)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(got), np.asarray(JC.scatter_max(jg, jnp.asarray(msg))))


def test_scan_or_unroll_runs_the_stack_in_order():
    stack = {"a": torch.arange(4.0)[:, None], "b": torch.ones(4, 1)}
    seen = []

    def layer(c, lp):
        seen.append(float(lp["a"][0]))
        return c * 2 + lp["a"] + lp["b"], None

    out = TC.scan_or_unroll(layer, torch.zeros(1), stack)
    assert seen == [0.0, 1.0, 2.0, 3.0]
    assert float(out[0]) == ((0 * 2 + 1) * 2 + 2) * 2 * 2 + 3 * 2 + 4


# ---------------------------------------------------------------------------
# twins of tests/test_models.py's equivariance tests
# ---------------------------------------------------------------------------

def test_egnn_is_e3_equivariant():
    """Rotating + translating input coordinates must rotate/translate the
    output coordinates and leave the feature outputs invariant; each
    output equals the reference's."""
    from repro.models.gnn import egnn as jeg
    from repro_torch.models.gnn import egnn
    spec = get_arch("egnn")
    cfg = spec.smoke_cfg()
    jp, params = _params(jeg, cfg)
    rng = np.random.default_rng(0)
    n, e = 24, 96
    nodes = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)

    # random rotation (QR) + translation
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    t = rng.normal(size=(1, 3)).astype(np.float32)

    outs = []
    for p in (pos, pos @ Q.T + t):
        arrs = {"nodes": nodes, "senders": snd, "receivers": rcv, "pos": p,
                "n_graphs": 1}
        jg, tg = _batches(arrs, pos=True)
        h, x = egnn.forward(params, cfg, tg)
        jh, jx = jeg.forward(jp, cfg, jg)
        _close(h, jh)
        _close(x, jx)
        outs.append((_np(h), _np(x)))
    (h1, x1), (h2, x2) = outs
    np.testing.assert_allclose(h1, h2, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(x1 @ Q.T + t, x2, rtol=1e-3, atol=1e-4)


def test_gnn_node_permutation_equivariance():
    """GraphSAGE full-graph logits must permute with the node relabeling,
    and equal the reference's."""
    from repro.models.gnn import graphsage as jgs
    from repro_torch.models.gnn import graphsage
    spec = get_arch("graphsage-reddit")
    cfg = spec.smoke_cfg()
    jp, params = _params(jgs, cfg)
    rng = np.random.default_rng(0)
    n, e = 20, 60
    nodes = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    snd = rng.integers(0, n, e)
    rcv = rng.integers(0, n, e)
    perm = rng.permutation(n)
    inv = np.argsort(perm)

    outs = []
    for arrs in ({"nodes": nodes, "senders": snd.astype(np.int32),
                  "receivers": rcv.astype(np.int32), "n_graphs": 1},
                 {"nodes": nodes[perm], "senders": inv[snd].astype(np.int32),
                  "receivers": inv[rcv].astype(np.int32), "n_graphs": 1}):
        jg, tg = _batches(arrs, pos=False)
        o = graphsage.forward(params, cfg, tg)
        _close(o, jgs.forward(jp, cfg, jg))
        outs.append(_np(o))
    np.testing.assert_allclose(outs[0][perm], outs[1], rtol=1e-4, atol=1e-5)


def test_gnn_params_from_numpy_keeps_names_values_and_stacks():
    from repro.models.gnn import gatedgcn as jgc
    cfg = get_arch("gatedgcn").smoke_cfg()
    jp = jgc.init(cfg, jax.random.PRNGKey(2))
    tp = gnn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                               device=CPU)
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].device == torch.device(CPU)
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]))
    assert tuple(tp["layers/U"].shape) == (cfg.n_layers, cfg.d_hidden,
                                          cfg.d_hidden)
    t64 = gnn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                device=CPU, dtype="float64")
    assert all(v.dtype == torch.float64 for v in t64.values())


def test_entry_points_default_to_the_card():
    cfg = get_arch("graphsage-reddit").smoke_cfg()
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default places on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgnn.graphsage.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_params_from_numpy({"w": np.zeros(2, np.float32)})
