"""Dynamic Frontier (DF) marking (paper §4.1) and Dynamic Traversal (DT)
reachability marking (ports ``src/repro/core/frontier.py``).

All marking is an idempotent OR.  The helpers of the fused driver
(``pack_batch``, ``block_any``, ``compact_block_ids``) and the snapshot
markings (``initial_affected``, ``expand_frontier``) never synchronise with
the host.  Two read the host, as the reference's do: the helping loop of
``initial_affected_with_helping`` checks ``C`` once per round, and the DT
breadth-first search of ``dt_affected`` polls its frontier once per
:data:`HOPS_PER_POLL` hops.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.graph import GraphSnapshot, _or_scatter, out_neighbor_or
from repro_torch.device import resolve_device

#: DT hops run between two reads of the frontier (the drivers' chunk size)
HOPS_PER_POLL = 8


def pack_batch(n_pad: int, deletions: np.ndarray, insertions: np.ndarray,
               *, bucket: int = 1024, device="cuda") -> torch.Tensor:
    """Pack a batch update into a padded [b_pad, 2] int32 tensor on
    ``device``.  Padded rows use the phantom vertex ``n_pad`` as source."""
    b = np.concatenate([np.asarray(deletions, np.int64).reshape(-1, 2),
                        np.asarray(insertions, np.int64).reshape(-1, 2)], 0)
    b_pad = max(bucket, ((len(b) + bucket - 1) // bucket) * bucket)
    out = np.full((b_pad, 2), n_pad, dtype=np.int32)
    if len(b):
        out[:len(b)] = b
    return torch.from_numpy(out).to(resolve_device(device))


def block_any(flags: torch.Tensor, n_blocks: int, block_size: int
              ) -> torch.Tensor:
    """Per-block OR over a [n_pad] vertex indicator → [n_blocks] bool."""
    return flags[:n_blocks * block_size].reshape(n_blocks,
                                                 block_size).any(dim=1)


def compact_block_ids(act: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Compacted active-block slot list: active ids first (ascending), then
    −1 padding — a fixed ``[n_blocks]`` int32 buffer.

    A prefix sum gives every active block its slot and one scatter writes
    it; inactive blocks scatter into a trash slot past the end.  Unlike
    ``torch.nonzero`` this has a static output shape and never waits for
    the device."""
    pos = torch.cumsum(act, dim=0) - 1
    dst = torch.where(act, pos, n_blocks)
    out = torch.full((n_blocks + 1,), -1, dtype=torch.int32,
                     device=act.device)
    out.scatter_(0, dst, torch.arange(n_blocks, dtype=torch.int32,
                                      device=act.device))
    return out[:n_blocks]


def batch_to_device(g: GraphSnapshot, deletions: np.ndarray,
                    insertions: np.ndarray, *, bucket: int = 1024
                    ) -> torch.Tensor:
    """Snapshot-keyed :func:`pack_batch`, on the snapshot's device."""
    return pack_batch(g.n_pad, deletions, insertions, bucket=bucket,
                      device=g.device)


def update_sources_indicator(g: GraphSnapshot, batch: torch.Tensor
                             ) -> torch.Tensor:
    """Indicator [n_pad] of the source vertices of the batch's updates."""
    ind = torch.zeros(g.n_pad + 1, dtype=torch.bool, device=g.device)
    ind[batch[:, 0].long().clamp(max=g.n_pad)] = True
    return ind[:g.n_pad] & g.vertex_valid


def initial_affected(g_prev: GraphSnapshot, g_cur: GraphSnapshot,
                     batch: torch.Tensor) -> torch.Tensor:
    """Paper lines 4-6 (Alg. 1): mark the out-neighbours of every update
    source in both G^{t-1} and G^t.  Sources are marked only through their
    self-loops."""
    aff = (out_neighbor_or(g_prev, update_sources_indicator(g_prev, batch))
           | out_neighbor_or(g_cur, update_sources_indicator(g_cur, batch)))
    return aff & g_cur.vertex_valid


def initial_affected_with_helping(
        g_prev: GraphSnapshot, g_cur: GraphSnapshot, batch: torch.Tensor,
        first_pass_mask) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fault-tolerant phase-1 marking with the paper's *helping* mechanism
    (Alg. 2 lines 5-16).  ``first_pass_mask`` [b_pad] says which updates
    their (possibly delayed or crashed) first owners processed; each
    helping round re-processes every update whose checked flag ``C`` is
    still 0 — OR-marking makes the duplicated work harmless.  Returns
    (affected, C, rounds)."""
    n_pad = g_cur.n_pad
    fp = torch.as_tensor(first_pass_mask, device=batch.device).to(torch.bool)
    real = batch[:, 0] < n_pad

    def mark(subset: torch.Tensor) -> torch.Tensor:
        sub = torch.where(subset[:, None], batch,
                          torch.full_like(batch, n_pad))
        return initial_affected(g_prev, g_cur, sub)

    affected = mark(fp & real)
    C = (fp & real) | ~real       # padded rows count as checked
    rounds = 0
    # one round suffices (the survivors process everything left); the loop
    # mirrors the paper's "while true ... all marked?"
    while bool((~C).any()):
        remaining = ~C
        affected = affected | mark(remaining)
        C = C | remaining
        rounds += 1
    return affected, C, rounds


def _dt_reach(g_prev: GraphSnapshot, g_cur: GraphSnapshot,
              batch: torch.Tensor, *, max_hops: int = 0
              ) -> Tuple[torch.Tensor, int, int]:
    """:func:`dt_affected` plus its hop count and host reads: (affected,
    hops with a non-empty frontier, polls)."""
    frontier = initial_affected(g_prev, g_cur, batch)
    affected = frontier
    limit = max_hops or g_cur.n_blocks * g_cur.block_size
    osrc, odst = g_cur.osrc.long(), g_cur.odst.long()
    hops = torch.zeros((), dtype=torch.long, device=g_cur.device)
    done = polls = 0
    while done < limit:
        # a hop from an empty frontier adds nothing, so the hops of a chunk
        # that run after the frontier empties are no-ops
        for _ in range(min(HOPS_PER_POLL, limit - done)):
            hops += frontier.any()
            new = _or_scatter(osrc, odst, frontier, g_cur.vertex_valid) \
                & ~affected
            frontier, affected = new, affected | new
        done += min(HOPS_PER_POLL, limit - done)
        polls += 1
        if not bool(frontier.any()):            # the poll
            break
    return affected, int(hops), polls


def dt_affected(g_prev: GraphSnapshot, g_cur: GraphSnapshot,
                batch: torch.Tensor, *, max_hops: int = 0) -> torch.Tensor:
    """Dynamic Traversal marking (Alg. 7): everything *reachable* in G^t
    from the out-neighbours of the update sources — a BFS of OR-SpMVs.
    The reference's device loop stops when the frontier empties or after
    ``max_hops`` (0: n_pad) hops; here the hops run in chunks of
    :data:`HOPS_PER_POLL` with one read of the frontier per chunk, and
    the marking is the same."""
    return _dt_reach(g_prev, g_cur, batch, max_hops=max_hops)[0]


def expand_frontier(g: GraphSnapshot, changed: torch.Tensor,
                    affected: torch.Tensor, rc: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper lines 15-17 (Alg. 1) / 25-28 (Alg. 2): mark the out-neighbours
    of the vertices whose rank moved more than τ_f (dense OR-SpMV form)."""
    hit = out_neighbor_or(g, changed)
    return affected | hit, rc | hit
