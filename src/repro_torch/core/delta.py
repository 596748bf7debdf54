"""Batch-update validation and generation (paper §5.1.4).

Ports ``src/repro/core/delta.py``, copied (numpy, host side):
``validate_edge_batch``, ``coalesce_batches``, ``random_batch``,
``signed_edge_delta``, ``pure_deletion_batch`` and ``temporal_batches``.
Random batches mix deletions (sampled uniformly from existing edges) and
insertions (uniform random non-connected pairs), sized as a fraction of
|E|.  Temporal batches are consecutive slices of a timestamped edge stream
after loading a 90% prefix.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import HostGraph


def _as_edge_array(arr, what: str, n: int) -> np.ndarray:
    """Canonicalize one side of a batch into an ``(k, 2) int64`` array,
    rejecting malformed input with a clear error instead of letting it
    reach a device scatter (or a WAL append) as garbage."""
    a = np.asarray(arr)
    if a.dtype == object:
        raise ValueError(f"{what} must be numeric edge pairs, got object "
                         f"dtype (value: {arr!r})")
    if a.size == 0:
        return np.zeros((0, 2), np.int64)
    if a.ndim > 2 or (a.ndim == 2 and a.shape[1] != 2) \
            or (a.ndim == 1 and a.size % 2 != 0):
        raise ValueError(f"{what} must be (k, 2) edge pairs, got shape "
                         f"{a.shape}")
    if np.issubdtype(a.dtype, np.floating):
        # NaN/inf survive a bare .astype(int64) as garbage vertex ids —
        # this is where they get caught, before anything is applied
        if not np.isfinite(a).all():
            raise ValueError(f"{what} contain non-finite (NaN/inf) vertex "
                             "ids")
        if not (a == np.floor(a)).all():
            raise ValueError(f"{what} contain non-integral vertex ids "
                             "(fractional floats)")
    elif not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{what} must be integer edge pairs, got dtype "
                         f"{a.dtype}")
    e = a.astype(np.int64).reshape(-1, 2)
    bad = (e < 0) | (e >= n)
    if bad.any():
        where = e[bad.any(axis=1)][:8].tolist()
        raise ValueError(
            f"{what} contain out-of-range vertex id(s) {where} for a graph "
            f"with {n} vertices (valid ids: 0..{n - 1})")
    return e


def _edge_keys(e: np.ndarray, n: int) -> np.ndarray:
    return e[:, 0] * np.int64(n) + e[:, 1]


def validate_edge_batch(deletions, insertions, n: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate one ``(deletions, insertions)`` update batch against an
    ``n``-vertex graph and return the canonical ``(k, 2) int64`` arrays.

    Raises ``ValueError`` on NaN/inf/non-integral vertex ids, out-of-range
    ids, self-loop insertions, duplicate edges within either side, or an
    edge appearing in both sides (ambiguous order within one batch).
    Sessions call this *before* the WAL append and before any device
    scatter, so a bad batch is never durably logged or half-applied."""
    dels = _as_edge_array(deletions, "deletions", n)
    ins = _as_edge_array(insertions, "insertions", n)
    loops = ins[:, 0] == ins[:, 1]
    if loops.any():
        raise ValueError(
            f"insertions contain self-loop(s) {ins[loops][:8].tolist()} — "
            "self-loops are managed internally (added per snapshot) and "
            "cannot be inserted")
    dk, ik = _edge_keys(dels, n), _edge_keys(ins, n)
    for what, keys, e in (("deletions", dk, dels), ("insertions", ik, ins)):
        uniq, cnt = np.unique(keys, return_counts=True)
        if (cnt > 1).any():
            dup = uniq[cnt > 1][:8]
            pairs = np.stack([dup // n, dup % n], 1).tolist()
            raise ValueError(f"{what} contain duplicate edge(s) {pairs} — "
                             "de-duplicate the batch before submitting")
    both = np.intersect1d(dk, ik)
    if both.size:
        pairs = np.stack([both[:8] // n, both[:8] % n], 1).tolist()
        raise ValueError(
            f"edge(s) {pairs} appear in both deletions and insertions of "
            "one batch — the order of operations within a batch is "
            "undefined; split them across two batches")
    return dels, ins


def coalesce_batches(batches: Sequence[Tuple[np.ndarray, np.ndarray]],
                     n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an ordered run of update batches into ONE equivalent
    ``(deletions, insertions)`` batch (last write per edge wins).

    Insert-then-delete nets to a deletion (a no-op if the edge never
    existed), delete-then-insert to an insertion.  The result has no
    duplicates and no del/ins overlap, so it passes
    :func:`validate_edge_batch` by construction."""
    key_op: dict = {}
    for dels, ins in batches:
        d = np.asarray(dels, np.int64).reshape(-1, 2)
        i = np.asarray(ins, np.int64).reshape(-1, 2)
        for k in _edge_keys(d, n):
            key_op[int(k)] = -1
        for k in _edge_keys(i, n):
            key_op[int(k)] = +1
    if not key_op:
        z = np.zeros((0, 2), np.int64)
        return z, z

    def unpack(keys):
        a = np.asarray(sorted(keys), np.int64)
        if not a.size:
            return np.zeros((0, 2), np.int64)
        return np.stack([a // n, a % n], 1)

    return (unpack([k for k, op in key_op.items() if op < 0]),
            unpack([k for k, op in key_op.items() if op > 0]))


def random_batch(g: HostGraph, frac: float, *, seed: int = 0,
                 deletions_frac: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Random batch of size ``frac * |E|``: mix of deletions and insertions."""
    rng = np.random.default_rng(seed)
    b = max(1, int(round(frac * g.m)))
    n_del = int(b * deletions_frac)
    n_ins = b - n_del

    dels = np.zeros((0, 2), dtype=np.int64)
    if n_del and g.m:
        idx = rng.choice(g.m, size=min(n_del, g.m), replace=False)
        dels = g.edges[idx]

    ins = np.zeros((0, 2), dtype=np.int64)
    if n_ins:
        cand = np.stack([rng.integers(0, g.n, 2 * n_ins),
                         rng.integers(0, g.n, 2 * n_ins)], 1)
        cand = cand[cand[:, 0] != cand[:, 1]]
        keep = ~g.has_edges(cand)
        ins = cand[keep][:n_ins]
    return dels, ins


def signed_edge_delta(deletions: np.ndarray, insertions: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a (deletions, insertions) batch into the signed coordinate
    form the incremental block-sparse builder consumes, in *pull* layout
    (rows = dst, cols = src): deletions carry -1, insertions +1."""
    dels = np.asarray(deletions, np.int64).reshape(-1, 2)
    ins = np.asarray(insertions, np.int64).reshape(-1, 2)
    rows = np.concatenate([dels[:, 1], ins[:, 1]])
    cols = np.concatenate([dels[:, 0], ins[:, 0]])
    vals = np.concatenate([-np.ones(len(dels)), np.ones(len(ins))])
    return rows, cols, vals


def pure_deletion_batch(g: HostGraph, frac: float, *, seed: int = 0
                        ) -> np.ndarray:
    """For the stability experiment (§5.2.3): a delete-only batch."""
    rng = np.random.default_rng(seed)
    b = max(1, min(int(round(frac * g.m)), g.m))
    idx = rng.choice(g.m, size=b, replace=False)
    return g.edges[idx]


def temporal_batches(stream: np.ndarray, *, prefix_frac: float = 0.9,
                     batch_frac: float = 1e-3
                     ) -> Tuple[np.ndarray, Iterator[np.ndarray]]:
    """Split a timestamped stream into a 90% prefix + fixed-size batches."""
    m_total = stream.shape[0]
    cut = int(prefix_frac * m_total)
    bs = max(1, int(batch_frac * m_total))

    def batches() -> Iterator[np.ndarray]:
        for lo in range(cut, m_total, bs):
            yield stream[lo:lo + bs]

    return stream[:cut], batches()
