"""Host helpers of the sharded topology (ports part of
``src/repro/core/distributed.py``).

Only :func:`df_seed_indices` is here so far: the tiered stream session's
host-side Dynamic Frontier seed calls it.  ROADMAP item A 14 (the sharded
topology) fills in the rest of the module — ``DistRuntime``, the exchange
modes, ``shrink`` and ``collective_bytes_per_sweep``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import HostGraph


def df_seed_indices(hg_prev: HostGraph, hg_cur: HostGraph,
                    sources: np.ndarray) -> np.ndarray:
    """Paper Alg. 1 lines 4-6 on the host in O(batch · deg): the
    out-neighbors of every update source in G^{t-1} **and** G^t, plus the
    sources themselves (every device graph carries per-vertex self-loops,
    so a source is its own out-neighbor, as in
    :func:`repro_torch.core.frontier.initial_affected`)."""
    sources = np.unique(np.asarray(sources, np.int64).reshape(-1))
    sources = sources[(sources >= 0) & (sources < hg_cur.n)]
    out = [sources]
    for hg in (hg_prev, hg_cur):
        keys = hg._keys
        n = np.int64(hg.n)
        lo = np.searchsorted(keys, sources * n)
        hi = np.searchsorted(keys, (sources + 1) * n)
        for k0, k1 in zip(lo.tolist(), hi.tolist()):
            if k1 > k0:
                out.append(keys[k0:k1] % n)
    return np.unique(np.concatenate(out)) if out else sources
