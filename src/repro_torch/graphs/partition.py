"""Vertex partitioners of the sharded topology (ports
``src/repro/graphs/partition.py``, numpy over the port's ``HostGraph``).

The sharded runtime (:mod:`repro_torch.core.distributed`) lays vertices out
contiguously: shard d owns ``[d·n_loc, (d+1)·n_loc)``.  A partitioner
relabels the vertex space first, so the vertices it puts on one shard sit
in one contiguous run:

  * ``contiguous`` — vertex v → shard v // n_loc (road networks and k-mer
    chains already have index locality, so a low edge cut);
  * ``hash``       — vertex v → shard hash(v) % n_dev (balanced, with the
    worst edge cut; for an adversarial id space);
  * ``bfs_blocks`` — a BFS-order relabeling, then the contiguous split (a
    cheap locality-recovering partition for power-law graphs).

``edge_cut`` is the fraction of edges whose endpoints lie on different
shards, which the exchange's traffic follows.  Orders, inverses, owners
and cuts are array-equal to the reference's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import HostGraph

PARTITIONERS = ("contiguous", "hash", "bfs_blocks")


def contiguous(n: int, n_dev: int) -> np.ndarray:
    n_loc = -(-n // n_dev)
    return np.arange(n) // n_loc


def hashed(n: int, n_dev: int, *, seed: int = 0x9E3779B9) -> np.ndarray:
    v = np.arange(n, dtype=np.uint64)
    v = (v * np.uint64(seed)) & np.uint64(0xFFFFFFFF)
    return (v % np.uint64(n_dev)).astype(np.int64)


def bfs_order(hg: HostGraph) -> np.ndarray:
    """BFS relabeling of the undirected view: ``order[new_id] = old_id``.
    Seeds are taken in id order; a vertex's neighbours are its out-edges'
    heads, then its in-edges' tails, each ascending; a level lists the
    vertices in the order they are first met, scanning its frontier in
    order.  The reference walks it a vertex at a time in Python; here a
    level at a time in numpy, which gives the same order."""
    e = hg.edges
    n = hg.n
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order_idx = np.argsort(src, kind="stable")
    src_s, dst_s = src[order_idx], dst[order_idx]
    ptr = np.searchsorted(src_s, np.arange(n + 1))
    deg = np.diff(ptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in range(n):
        if visited[seed]:
            continue
        visited[seed] = True
        if deg[seed] == 0:              # a vertex with no edge: its own BFS
            order[pos] = seed
            pos += 1
            continue
        frontier = np.array([seed], dtype=np.int64)
        while len(frontier):
            order[pos:pos + len(frontier)] = frontier
            pos += len(frontier)
            lens = deg[frontier]
            # the frontier's neighbour lists, concatenated in frontier order
            first = np.cumsum(lens) - lens
            cand = dst_s[np.repeat(ptr[frontier] - first, lens)
                         + np.arange(int(lens.sum()))]
            cand = cand[~visited[cand]]
            _, at = np.unique(cand, return_index=True)
            frontier = cand[np.sort(at)]
            visited[frontier] = True
    return order


def bfs_blocks(hg: HostGraph, n_dev: int) -> np.ndarray:
    """Vertex → shard map of the BFS-order contiguous split."""
    order = bfs_order(hg)
    owner = np.empty(hg.n, dtype=np.int64)
    owner[order] = contiguous(hg.n, n_dev)
    return owner


def make_partition(hg: HostGraph, n_dev: int, kind: str = "contiguous",
                   *, seed: int = 0x9E3779B9
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(order, inv, owner)`` of the partitioner ``kind``.

    ``owner[old_id]`` is the shard the partitioner asks for; ``order``
    (``order[new_id] = old_id``) groups the vertices of one owner
    contiguously, stable within a shard; ``inv`` is its inverse
    (``inv[old_id] = new_id``).  The runtime gives every shard
    ``ceil(n/n_dev)`` vertices, so the shard a vertex really lands on is
    ``inv[v] // n_loc``: the request for a balanced partitioner, a few
    boundary vertices off it otherwise (``hash``)."""
    if kind == "contiguous":
        owner = contiguous(hg.n, n_dev)
    elif kind == "hash":
        owner = hashed(hg.n, n_dev, seed=seed)
    elif kind == "bfs_blocks":
        owner = bfs_blocks(hg, n_dev)
    else:
        raise ValueError(f"unknown partitioner {kind!r}; "
                         f"expected one of {PARTITIONERS}")
    order = np.argsort(owner, kind="stable")
    inv = np.empty(hg.n, dtype=np.int64)
    inv[order] = np.arange(hg.n)
    return order, inv, owner


def edge_cut(hg: HostGraph, owner: np.ndarray) -> float:
    """Fraction of edges whose endpoints live on different shards."""
    e = hg.edges
    if len(e) == 0:
        return 0.0
    return float(np.mean(owner[e[:, 0]] != owner[e[:, 1]]))


def relabel(hg: HostGraph, order: np.ndarray) -> Tuple[HostGraph, np.ndarray]:
    """Apply a vertex relabeling; returns (new graph, inverse map)."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    e = hg.edges
    return HostGraph(hg.n, np.stack([inv[e[:, 0]], inv[e[:, 1]]], 1)), inv
