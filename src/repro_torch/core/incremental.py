"""Incremental maintenance of dynamic-graph state (ports
``src/repro/core/incremental.py``).

* :class:`IncrementalPullMatrix` keeps the block-sparse pull matrix in step
  with a dynamic edge stream by patching only the tiles each batch touches
  (``ops.apply_delta``, in place on the device), and caches the per-block
  engine operands (:class:`MatrixAux`, host numpy twins) updated in
  O(batch).
* :func:`incremental_gnn_update` is the Dynamic Frontier applied to a
  layered GNN: after a batch of edge updates the affected set grows layer
  by layer, through the out-neighbors of nodes whose activation moved more
  than τ_f.  As in the reference, every layer is computed in full and then
  masked; the work a deployment would save is counted in ``stats``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.delta import signed_edge_delta
from repro_torch.core.graph import GraphSnapshot, HostGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.block_spmv import ops


def effective_batch(hg_prev: HostGraph, deletions: np.ndarray,
                    insertions: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Filter a raw (deletions, insertions) batch down to the edges that
    actually change the graph, mirroring :meth:`HostGraph.apply_batch`
    exactly: dedupe, drop self-loops, deletions of absent edges are no-ops,
    insertions land in (prev − dels) — so an edge deleted and re-inserted
    in one batch nets to zero."""
    n = np.int64(hg_prev.n)

    def uniq(e):
        e = np.asarray(e, np.int64).reshape(-1, 2)
        e = e[e[:, 0] != e[:, 1]]
        k = np.unique(e[:, 0] * n + e[:, 1])
        return np.stack([k // n, k % n], 1), k

    dels, del_keys = uniq(deletions)
    ins, ins_keys = uniq(insertions)
    dels = dels[hg_prev.has_edges(dels)] if len(dels) else dels
    if len(ins):
        present = hg_prev.has_edges(ins)
        redeleted = np.isin(ins_keys, del_keys) if len(del_keys) else \
            np.zeros(len(ins), bool)
        ins = ins[~present | (present & redeleted)]
    return dels, ins


@dataclasses.dataclass
class MatrixAux:
    """Per-block engine operands cached alongside the pull matrix (host
    numpy): ``bmat`` tile-presence adjacency [n_rb, n_cb] (monotone under
    deltas), ``rb_in`` in-edges per dst-block, ``rb_out`` out-edges per
    src-block.  All three update in O(batch)."""
    bmat: np.ndarray     # [n_rb, n_cb] bool
    rb_in: np.ndarray    # [n_rb] i32
    rb_out: np.ndarray   # [n_rb] i32

    @classmethod
    def from_parts(cls, mat: ops.BlockSparse, g: GraphSnapshot
                   ) -> "MatrixAux":
        return cls(bmat=ops.block_adjacency(mat).cpu().numpy().copy(),
                   rb_in=g.block_in_edges().cpu().numpy().copy(),
                   rb_out=g.block_out_edges().cpu().numpy().copy())

    def apply_delta(self, block: int, rows: np.ndarray, cols: np.ndarray,
                    vals: np.ndarray) -> None:
        """O(batch) in-place update from signed pull-layout coordinates
        (rows = dst, cols = src, vals = ±1).  In place, unlike the JAX
        package (whose device arrays may alias these buffers): the port's
        device operands are copies, so nothing else sees these arrays."""
        if len(rows) == 0:
            return
        rb = np.asarray(rows, np.int64) // block
        cb = np.asarray(cols, np.int64) // block
        v = np.asarray(vals).astype(self.rb_in.dtype)
        np.add.at(self.rb_in, rb, v)
        np.add.at(self.rb_out, cb, v)
        self.bmat[rb, cb] = True


class IncrementalPullMatrix:
    """Block-sparse pull matrix maintained incrementally across a stream.

    ``advance`` filters the batch against the previous host graph the way
    :meth:`HostGraph.apply_batch` does (:func:`effective_batch`), so tile
    values track edge multiplicity exactly.  Structure grows monotonically —
    emptied tiles stay as zero blocks.  The tile pool is patched in place:
    the matrix before ``advance`` and after it share one pool unless the
    batch overflowed its capacity bucket."""

    def __init__(self, mat: ops.BlockSparse, aux: Optional[MatrixAux] = None):
        self.mat = mat
        self.aux = aux

    @classmethod
    def from_snapshot(cls, g: GraphSnapshot, dtype=torch.float64,
                      padded: bool = True) -> "IncrementalPullMatrix":
        from repro_torch.core.pallas_engine import build_pull_matrix
        mat = build_pull_matrix(g, dtype=dtype, padded=padded)
        return cls(mat, MatrixAux.from_parts(mat, g))

    def advance(self, hg_prev: HostGraph, g_new: Optional[GraphSnapshot],
                deletions: np.ndarray, insertions: np.ndarray, *,
                effective: Optional[Tuple[np.ndarray, np.ndarray]] = None
                ) -> ops.BlockSparse:
        """Patch the matrix (and cached aux) with one edge batch.  ``g_new``
        is only consulted for the grid check and may be None on a stream.
        ``effective`` may carry an already-filtered (dels, ins) pair."""
        if g_new is not None and g_new.n_pad > self.mat.n_rows:
            raise ValueError("snapshot outgrew the matrix block grid; "
                             "rebuild with from_snapshot")
        dels, ins = (effective if effective is not None
                     else effective_batch(hg_prev, deletions, insertions))
        rows, cols, vals = signed_edge_delta(dels, ins)
        self.mat = ops.apply_delta(self.mat, rows, cols, vals)
        if self.aux is not None:
            self.aux.apply_delta(self.mat.block, rows, cols, vals)
        return self.mat


# ---------------------------------------------------------------------------
# the DF-incremental GNN update
# ---------------------------------------------------------------------------

def edge_update_sources(n_pad: int, deletions: np.ndarray,
                        insertions: np.ndarray, *, device="cuda"
                        ) -> torch.Tensor:
    """Indicator of update source vertices (both endpoints for undirected
    message passing: a changed edge changes BOTH endpoints' aggregations)."""
    ind = np.zeros(n_pad + 1, dtype=bool)
    for batch in (deletions, insertions):
        b = np.asarray(batch, np.int64).reshape(-1, 2)
        ind[np.minimum(b[:, 0], n_pad)] = True
        ind[np.minimum(b[:, 1], n_pad)] = True
    return torch.from_numpy(ind[:n_pad]).to(resolve_device(device))


def out_neighbors_or(g, flags: torch.Tensor) -> torch.Tensor:
    """Nodes receiving at least one message from a flagged node (``g`` a
    :class:`repro_torch.models.gnn.common.GraphBatch`)."""
    f = torch.cat([flags.to(torch.int32),
                   torch.zeros(1, dtype=torch.int32, device=flags.device)])
    hits = torch.zeros(g.n_pad + 1, dtype=torch.int32, device=flags.device)
    hits.index_add_(0, g.receivers, f[g.senders.clamp(max=g.n_pad)])
    return hits[:g.n_pad] > 0


def incremental_gnn_update(
        layer_fns: Sequence[Callable], g, h0: torch.Tensor,
        cached_layers: Sequence[torch.Tensor], sources: torch.Tensor, *,
        tau_f: float) -> Tuple[torch.Tensor, List[torch.Tensor], Dict]:
    """Recompute a layered GNN after a graph update, DF-style.

    layer_fns[i](g, h) -> h'  — full-graph layer functions;
    cached_layers[i]          — pre-update activations per layer (i=0 input);
    sources                   — indicator of update-source nodes.

    Per layer: currently-affected nodes take the new activation, the others
    keep their cached one; then the frontier expands to the out-neighbors
    of nodes whose activation moved more than τ_f — the DF gate.  Returns
    the new final activations, the refreshed cache and the work counters
    (``recomputed``, ``total`` as the reference counts them; the port adds
    ``affected``, the affected count of each layer).
    """
    affected = out_neighbors_or(g, sources) | sources
    new_cache = [h0]
    h = h0
    stats = {"recomputed": 0, "total": 0, "affected": []}
    for i, fn in enumerate(layer_fns):
        full = fn(g, h)     # every row computed, as the reference does
        prev = cached_layers[i + 1]
        h_new = torch.where(affected[:, None], full, prev)
        moved = affected & ((h_new - prev).abs().amax(dim=-1) > tau_f)
        n_aff = int(affected.sum())
        stats["affected"].append(n_aff)
        stats["recomputed"] += n_aff
        stats["total"] += int(g.n_pad)
        affected = affected | out_neighbors_or(g, moved)
        new_cache.append(h_new)
        h = h_new
    return h, new_cache, stats


def full_gnn_layers(mod, params, cfg) -> List[Callable]:
    """Adapt a model-zoo family into per-layer closures for the incremental
    path (graphsage-style: h' = layer(h))."""
    if cfg.family != "graphsage":
        raise NotImplementedError(
            "incremental path is exercised on graphsage (mean aggregation "
            "is layer-local); other families need their edge state threaded")
    from repro_torch.models.gnn import common as C
    from repro_torch.models.gnn import graphsage as GS

    def make(i):
        def fn(g, h):
            neigh = C.scatter_mean(g, C.gather_src(g, h))
            return GS._layer(params, i, h, neigh)
        return fn

    return [make(i) for i in range(cfg.n_layers)]
