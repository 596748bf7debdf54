"""Shared GNN substrate: graph batches, segment message passing, MLP blocks
(ports ``src/repro/models/gnn/common.py``).

Message passing is a gather along edges (``index_select``) and a
scatter-aggregate by destination.  The sums add each destination's messages
in edge-array order, as the reference's ``jax.ops.segment_sum`` does on the
CPU, on every device: a stable sort of the destinations (kept while their
tensor is unchanged) and ``torch.segment_reduce`` over the sorted messages,
so a sum is the same bits on the CPU and the card and from run to run.
``scatter_max`` (``scatter_reduce``) is exact in any order.  Edge arrays may
be padded with ``src = dst = n_pad`` (a phantom node), so padded edges
aggregate into a discarded bin, as in the reference.

``shard_edges`` and ``constrain`` (the reference's sharding constraints)
are the identity on one device and are not ported (ROADMAP watch list);
``scan_or_unroll`` is a plain loop over the stacked leading axis: the
config's ``scan_layers`` and ``remat`` pick the reference's lowering and
change nothing in a forward pass.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.device import as_torch_dtype, resolve_device


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str                    # "gatedgcn" | "egnn" | "graphsage" | "meshgraphnet"
    n_layers: int
    d_hidden: int
    d_feat: int                    # input node feature dim
    n_out: int                     # classes (node_clf) or regression dim
    task: str = "node_clf"         # "node_clf" | "node_reg" | "graph_reg"
    aggregator: str = "sum"        # graphsage: "mean"; gatedgcn: "gated"
    d_edge_feat: int = 0           # input edge feature dim (0 = none)
    mlp_layers: int = 2            # meshgraphnet MLP depth
    sample_sizes: Tuple[int, ...] = ()   # graphsage default fanouts
    dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True       # False: unroll (exact dry-run HLO flops)


class GraphBatch(NamedTuple):
    """One (possibly batched/padded) graph on a device.

    ``senders/receivers`` index into the flattened node array; padded edges
    point at node ``n_pad`` (one past the last row — the scatter bins hold
    +1 row, ``nodes`` does not).
    """
    nodes: torch.Tensor                 # [N, F] float
    senders: torch.Tensor               # [E] int
    receivers: torch.Tensor             # [E] int
    edge_feat: Optional[torch.Tensor] = None   # [E, Fe]
    pos: Optional[torch.Tensor] = None  # [N, 3] (egnn / meshgraphnet)
    graph_id: Optional[torch.Tensor] = None    # [N] int (batched small graphs)
    n_graphs: int = 1
    node_mask: Optional[torch.Tensor] = None   # [N] bool
    edge_mask: Optional[torch.Tensor] = None   # [E] bool

    @property
    def n_pad(self) -> int:
        return int(self.nodes.shape[0])


# ---------------------------------------------------------------------------
# message passing primitives
# ---------------------------------------------------------------------------

def mask_edges(g: GraphBatch, v: torch.Tensor) -> torch.Tensor:
    if g.edge_mask is None:
        return v
    return torch.where(g.edge_mask[:, None], v, torch.zeros((), dtype=v.dtype,
                                                            device=v.device))


def gather_src(g: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """h[senders] with phantom-safe clamping; padded edges yield zeros."""
    return mask_edges(g, h.index_select(0, g.senders.clamp(max=g.n_pad - 1)))


def gather_dst(g: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    return mask_edges(g, h.index_select(0,
                                         g.receivers.clamp(max=g.n_pad - 1)))


class SegmentOrder(NamedTuple):
    """Entries of a segment-id array grouped by segment: ``perm`` is the
    stable argsort of the ids (each segment's entries in array order) and
    ``lengths`` the size of each of the ``n_bins`` segments."""
    perm: torch.Tensor
    lengths: torch.Tensor


# id(ids tensor) -> (weak reference, its version, n_bins, SegmentOrder)
_ORDERS: Dict[int, tuple] = {}


def segment_order(seg: torch.Tensor, n_bins: int) -> SegmentOrder:
    """The :class:`SegmentOrder` of ``seg`` (ids in ``[0, n_bins)``), sorted
    once and kept while ``seg`` lives unmodified: an edge array changed in
    place through torch (its version counter moves) is sorted again at its
    next use.  A write that goes around torch — into a numpy view of a CPU
    tensor — is not seen; write edge arrays through torch."""
    key = id(seg)
    hit = _ORDERS.get(key)
    if hit is not None and hit[0]() is seg and hit[1] == seg._version \
            and hit[2] == n_bins:
        return hit[3]
    perm = torch.sort(seg, stable=True).indices.to(seg.dtype)
    lengths = torch.zeros(n_bins, dtype=torch.int64, device=seg.device)
    lengths.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int64))
    order = SegmentOrder(perm, lengths)
    _ORDERS[key] = (weakref.ref(seg, lambda _, k=key: _ORDERS.pop(k, None)),
                    seg._version, n_bins, order)
    return order


def sorted_segment_sum(xs: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """Per-segment sums of rows already grouped by segment (``xs[perm]``),
    each segment added in row order from 0.  The rows go in as a 2-D
    tensor, so the card takes ``segment_reduce``'s serial loop per output
    element rather than its tree reduction for 1-D data.  ``lengths`` are
    counts of ids (non-negative, summing to the rows), so the op's own
    checks of them, two host reads a call, are skipped (``unsafe``)."""
    flat = xs.reshape(xs.shape[0], -1)
    out = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return out.reshape((lengths.shape[0],) + tuple(xs.shape[1:]))


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n_bins: int
                 ) -> torch.Tensor:
    """Σ over the rows of ``x`` with each id, in row order."""
    order = segment_order(seg, n_bins)
    return sorted_segment_sum(x.index_select(0, order.perm), order.lengths)


def scatter_sum(g: GraphBatch, messages: torch.Tensor) -> torch.Tensor:
    """Σ_{e: dst(e)=v} messages[e]  →  [N, d]; padded edges land in bin N."""
    return _segment_sum(messages, g.receivers, g.n_pad + 1)[:g.n_pad]


def _edge_counts(g: GraphBatch, order: SegmentOrder, dtype) -> torch.Tensor:
    """In-edges per destination (unmasked ones), exact, as ``dtype``."""
    if g.edge_mask is None:
        cnt = order.lengths
    else:
        cnt = torch.zeros_like(order.lengths).index_add_(
            0, g.receivers, g.edge_mask.to(torch.int64))
    return cnt[:g.n_pad].to(dtype)


def scatter_mean(g: GraphBatch, messages: torch.Tensor) -> torch.Tensor:
    s = scatter_sum(g, messages)
    cnt = _edge_counts(g, segment_order(g.receivers, g.n_pad + 1), s.dtype)
    return s / cnt.clamp(min=1.0)[:, None]


def mean_aggregate(g: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """``scatter_mean(g, gather_src(g, h))``, the same bits, with the gather
    taken in destination order: ``h[senders[perm]]`` feeds the segment sum
    directly, so no second ``[E, d]`` tensor is made."""
    order = segment_order(g.receivers, g.n_pad + 1)
    src = g.senders.index_select(0, order.perm).clamp_(max=g.n_pad - 1)
    v = h.index_select(0, src)
    del src
    if g.edge_mask is not None:
        v.masked_fill_(~g.edge_mask.index_select(0, order.perm)[:, None], 0)
    s = sorted_segment_sum(v, order.lengths)[:g.n_pad]
    del v
    return s / _edge_counts(g, order, s.dtype).clamp(min=1.0)[:, None]


def scatter_max(g: GraphBatch, messages: torch.Tensor) -> torch.Tensor:
    """Per-destination max, then the reference's clamp at 0: empty bins
    (−inf) and negative maxima both come out as 0."""
    out = torch.full((g.n_pad + 1,) + tuple(messages.shape[1:]),
                     float("-inf"), dtype=messages.dtype,
                     device=messages.device)
    idx = g.receivers.long().reshape((-1,) + (1,) * (messages.dim() - 1))
    out.scatter_reduce_(0, idx.expand_as(messages), messages, "amax",
                        include_self=False)
    return out[:g.n_pad].clamp(min=0)


def graph_readout(g: GraphBatch, h: torch.Tensor, *, op: str = "mean"
                  ) -> torch.Tensor:
    """Per-graph pooling for batched small graphs → [n_graphs, d]."""
    gid = (g.graph_id if g.graph_id is not None
           else torch.zeros((g.n_pad,), dtype=torch.int64, device=h.device))
    if g.node_mask is not None:
        h = torch.where(g.node_mask[:, None], h,
                        torch.zeros((), dtype=h.dtype, device=h.device))
        gid = torch.where(g.node_mask, gid,
                          torch.full_like(gid, g.n_graphs))
    s = _segment_sum(h, gid, g.n_graphs + 1)[:g.n_graphs]
    if op == "sum":
        return s
    ones = torch.ones((g.n_pad,), dtype=h.dtype, device=h.device)
    if g.node_mask is not None:
        ones = ones * g.node_mask
    cnt = _segment_sum(ones, gid, g.n_graphs + 1)[:g.n_graphs]
    return s / cnt.clamp(min=1.0)[:, None]


# ---------------------------------------------------------------------------
# dense blocks
# ---------------------------------------------------------------------------

def mlp_shapes(d_in: int, d_hidden: int, d_out: int, n_layers: int
               ) -> Dict[str, Tuple[int, ...]]:
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
    s = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"w{i}"] = (a, b)
        s[f"b{i}"] = (b,)
    return s


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """(x − mean) · rsqrt(var + 1e-5) over the last axis, no scale."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              prefix: str = "", n_layers: int, act=F.relu,
              layernorm: bool = False) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"{prefix}w{i}"].to(x.dtype) \
            + p[f"{prefix}b{i}"].to(x.dtype)
        if i < n_layers - 1:
            x = act(x)
    if layernorm:
        x = layer_norm(x)
    return x


def as_generator(key: Union[int, torch.Generator]) -> torch.Generator:
    """A CPU ``torch.Generator``: ``key`` itself, or one seeded with it."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator()
    gen.manual_seed(int(key))
    return gen


def dense_init(gen: torch.Generator, shape, dtype=torch.float32
               ) -> torch.Tensor:
    """normal · fan_in^-½, drawn on the CPU from ``gen``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    return torch.randn(shape, generator=gen, dtype=dtype) * (fan_in ** -0.5)


def _is_bias(leaf: str) -> bool:
    return (leaf.startswith("b") and not leaf.startswith("bn")) or \
        any(re.fullmatch(r"b\d*", seg) for seg in leaf.split("_")) or \
        "bias" in leaf


def init_from_shapes(shapes: Dict[str, Tuple[int, ...]],
                     key: Union[int, torch.Generator], dtype=torch.float32,
                     *, device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's rules in sorted name order — ones for norms, zeros
    for biases, ``dense_init`` otherwise — drawn from a CPU generator (so
    the values do not depend on ``device``; they are not JAX's)."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    gen = as_generator(key)
    params = {}
    for name, shape in sorted(shapes.items()):
        leaf = name.split("/")[-1]
        if "norm" in leaf or leaf.startswith("ln"):
            t = torch.ones(shape, dtype=dtype)
        elif _is_bias(leaf):
            t = torch.zeros(shape, dtype=dtype)
        else:
            t = dense_init(gen, shape, dtype)
        params[name] = t.to(dev)
    return params


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def node_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = lg.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    nll = lse - ll
    m = (labels >= 0).float()
    if mask is not None:
        m = m * mask
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor]) -> torch.Tensor:
    err = (pred.float() - target.float()).square().mean(dim=-1)
    if mask is not None:
        return (err * mask).sum() / mask.sum().clamp(min=1.0)
    return err.mean()


def task_loss(cfg: GNNConfig, out: torch.Tensor, g: GraphBatch, labels
              ) -> torch.Tensor:
    """The families' shared ``loss_fn`` body: cross-entropy for node
    classification, MSE otherwise (graph_reg unmasked)."""
    mask = None if g.node_mask is None else g.node_mask.float()
    if cfg.task == "node_clf":
        return node_xent(out, labels, mask)
    if cfg.task == "graph_reg":
        return mse(out, labels, None)
    return mse(out, labels, mask)


def layer_stack(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked ``layers/*`` leaves, keyed by their name after the
    prefix."""
    return {k.split("/", 1)[1]: v for k, v in params.items()
            if k.startswith("layers/")}


def scan_or_unroll(layer_fn, carry, stack: Dict[str, torch.Tensor]):
    """Run ``layer_fn(carry, per_layer_params) -> (carry, None)`` over a
    stacked param dict, one leading-axis slice at a time."""
    n = next(iter(stack.values())).shape[0]
    for i in range(n):
        carry, _ = layer_fn(carry, {k: v[i] for k, v in stack.items()})
    return carry
