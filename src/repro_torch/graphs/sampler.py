"""GraphSAGE neighbor sampler (host-side, numpy CSR; ports
``src/repro/graphs/sampler.py``).

The real minibatch pipeline: build a CSR of out-neighbors once, then per
step sample ``fanouts`` neighbors per hop with replacement (isolated
vertices sample themselves), exactly as in the GraphSAGE paper.  Returns
*global* node-id arrays per hop; the data pipeline gathers features.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.graph import HostGraph


class NeighborSampler:
    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray):
        self.n = int(n)
        # np.argsort(src, kind="stable")'s permutation, from torch's stable
        # sort (a radix sort on the CPU, ~5x faster at 10^7 ids)
        order = torch.sort(torch.from_numpy(np.asarray(src, np.int64)),
                           stable=True).indices.numpy()
        self._dst = np.asarray(dst)[order]
        counts = np.bincount(np.asarray(src), minlength=n)
        self._ptr = np.concatenate([[0], np.cumsum(counts)])

    @classmethod
    def from_host_graph(cls, hg: HostGraph) -> "NeighborSampler":
        e = hg.edges
        return cls(hg.n, e[:, 0], e[:, 1])

    def degree(self, v: np.ndarray) -> np.ndarray:
        return self._ptr[v + 1] - self._ptr[v]

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
        """[len(nodes), fanout] global ids, sampled w/ replacement;
        zero-degree nodes yield themselves (self-loop semantics)."""
        nodes = np.asarray(nodes).reshape(-1)
        deg = self.degree(nodes)
        off = rng.integers(0, 1 << 31, size=(len(nodes), fanout))
        idx = self._ptr[nodes][:, None] + off % np.maximum(deg, 1)[:, None]
        out = self._dst[np.minimum(idx, len(self._dst) - 1)]
        return np.where(deg[:, None] > 0, out, nodes[:, None])

    def sample_block(self, seeds: np.ndarray, fanouts: Sequence[int],
                     rng: np.random.Generator) -> List[np.ndarray]:
        """Multi-hop sample: returns [seeds [B], hop1 [B,f1],
        hop2 [B,f1,f2], ...] of global node ids."""
        out = [np.asarray(seeds).reshape(-1)]
        cur = out[0]
        shape = (len(cur),)
        for f in fanouts:
            nxt = self.sample_neighbors(cur.reshape(-1), f, rng)
            shape = shape + (f,)
            out.append(nxt.reshape(shape))
            cur = nxt
        return out


def minibatch_stream(sampler: NeighborSampler, feats: np.ndarray,
                     labels: np.ndarray, batch_nodes: int,
                     fanouts: Sequence[int], *, seed: int = 0):
    """Yields (hop-feature list, seed labels) minibatches forever."""
    rng = np.random.default_rng(seed)
    while True:
        seeds = rng.integers(0, sampler.n, size=batch_nodes)
        hops = sampler.sample_block(seeds, fanouts, rng)
        yield [feats[h] for h in hops], labels[seeds]
