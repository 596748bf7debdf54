"""Synthetic graph generators (ports ``src/repro/graphs/generators.py``).

``rmat`` (power-law, web/social class), ``erdos_renyi`` (uniform),
``grid_road`` (2-D lattice with random shortcuts, road class),
``kmer_chains`` (long chains, protein k-mer class), ``powerlaw`` (Zipf
out-degrees) and ``temporal_stream`` (timestamped edge insertions, the
temporal-network class), copied: numpy on the host, and the same edge sets
and streams as the JAX package's per seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import HostGraph


def _dedupe(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    keys = src.astype(np.int64) * n + dst.astype(np.int64)
    keys = np.unique(keys)
    return np.stack([keys // n, keys % n], axis=1)


def rmat(n_log2: int, avg_degree: int = 16, *, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         chunk_edges: Optional[int] = None) -> HostGraph:
    """R-MAT generator (Chakrabarti et al.); power-law in/out degrees.

    ``chunk_edges`` bounds the build's transient host memory: the edge
    list is generated in chunks of that many edges (~40 bytes/edge of
    transients per chunk instead of per the whole graph — a 100M-edge
    build stays under a flat ceiling instead of peaking at ~4 GB), with
    progressive sorted-unique merging.  Seed-reproducible against the
    monolithic path bit-for-bit: each chunk re-derives the exact slice of
    the monolithic PCG64 random stream it would have consumed, via
    ``PCG64.advance`` (the monolithic build draws ``m`` uniforms per
    level, so chunk ``[lo, lo+k)`` of level ``L`` is the stream advanced
    by ``L*m + lo``)."""
    n = 1 << n_log2
    m = n * avg_degree
    if chunk_edges is not None:
        if chunk_edges <= 0:
            raise ValueError(f"chunk_edges={chunk_edges} must be positive")
        keys = np.empty(0, np.int64)
        for lo in range(0, m, chunk_edges):
            k = min(chunk_edges, m - lo)
            src = np.zeros(k, dtype=np.int64)
            dst = np.zeros(k, dtype=np.int64)
            for level in range(n_log2):
                bg = np.random.PCG64(seed)
                bg.advance(level * m + lo)
                r = np.random.Generator(bg).random(k)
                right = r >= a + b
                down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
                src |= (down.astype(np.int64) << level)
                dst |= (right.astype(np.int64) << level)
            ck = src * np.int64(n) + dst
            keys = np.union1d(keys, ck)     # sorted-unique merge
        return HostGraph(n, np.stack([keys // n, keys % n], axis=1))
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(m)
        # quadrant probabilities a,b,c,d
        right = r >= a + b
        down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= (down.astype(np.int64) << level)
        dst |= (right.astype(np.int64) << level)
    return HostGraph(n, _dedupe(n, src, dst))


def erdos_renyi(n: int, avg_degree: int = 8, *, seed: int = 0) -> HostGraph:
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return HostGraph(n, _dedupe(n, src, dst))


def grid_road(side: int, *, diag_frac: float = 0.05, seed: int = 0
              ) -> HostGraph:
    """2-D lattice digraph (both directions) + a few random shortcuts.
    Average degree ≈ 3-4, mirroring asia_osm / europe_osm."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    right = vid[(jj < side - 1).ravel()]
    down = vid[(ii < side - 1).ravel()]
    e = [np.stack([right, right + 1], 1), np.stack([right + 1, right], 1),
         np.stack([down, down + side], 1), np.stack([down + side, down], 1)]
    k = int(diag_frac * n)
    if k:
        s = rng.integers(0, n, k)
        d = rng.integers(0, n, k)
        e.append(np.stack([s, d], 1))
    return HostGraph(n, _dedupe(n, *np.concatenate(e).T))


def kmer_chains(n: int, chain_len: int = 64, *, seed: int = 0) -> HostGraph:
    """Disjoint long chains with sparse cross links (protein k-mer class)."""
    rng = np.random.default_rng(seed)
    v = np.arange(n - 1, dtype=np.int64)
    mask = (v + 1) % chain_len != 0
    fwd = np.stack([v[mask], v[mask] + 1], 1)
    bwd = fwd[:, ::-1]
    k = n // 50
    cross = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)], 1)
    return HostGraph(n, _dedupe(n, *np.concatenate([fwd, bwd, cross]).T))


def powerlaw(n: int, avg_degree: int = 8, *, seed: int = 0,
             exponent: float = 2.1) -> HostGraph:
    """Zipf out-degree digraph: vertex out-degrees follow a truncated
    power law with the given ``exponent`` (2.1 ≈ web crawls), rescaled to
    hit ``avg_degree`` on average; destinations are uniform."""
    if n < 2:
        raise ValueError(f"n={n} must be >= 2")
    if avg_degree < 1:
        raise ValueError(f"avg_degree={avg_degree} must be >= 1")
    if exponent <= 1.0:
        raise ValueError(f"exponent={exponent} must be > 1 (Zipf)")
    rng = np.random.default_rng(seed)
    deg = rng.zipf(exponent, size=n).astype(np.int64)
    np.minimum(deg, n - 1, out=deg)     # cap: simple digraph, no self-loop
    scale = avg_degree / max(deg.mean(), 1e-12)
    deg = np.maximum((deg * scale).astype(np.int64), 1)
    np.minimum(deg, n - 1, out=deg)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = rng.integers(0, n, size=src.size)
    keep = src != dst
    return HostGraph(n, _dedupe(n, src[keep], dst[keep]))


def temporal_stream(n: int, m_total: int, *, seed: int = 0,
                    preferential: bool = True) -> np.ndarray:
    """Timestamped edge insertions [m_total, 2]; later edges prefer recently
    active vertices (mirrors wiki-talk / stackoverflow growth)."""
    rng = np.random.default_rng(seed)
    if not preferential:
        return np.stack([rng.integers(0, n, m_total),
                         rng.integers(0, n, m_total)], 1)
    # preferential attachment-ish: sample dst from a growing popularity table
    src = rng.integers(0, n, m_total)
    pop = rng.integers(0, n, m_total)    # candidate by popularity recency
    uni = rng.integers(0, n, m_total)
    take_pop = rng.random(m_total) < 0.6
    dst = np.where(take_pop, pop * rng.random(m_total), uni).astype(np.int64)
    dst = np.clip(dst, 0, n - 1)
    return np.stack([src, dst], 1)
