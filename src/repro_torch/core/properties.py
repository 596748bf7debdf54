"""System invariants, written as checkable predicates (ports
``src/repro/core/properties.py``).  Each mirrors a claim the paper relies
on:

  I1  rank conservation  — Σ R[v] ≈ 1 at a PageRank fixed point (self-loop
      construction removes dead-end leakage);
  I2  idempotent marking — marking affected vertices twice == once (the
      property that makes the helping mechanism race-free, §4.4);
  I3  monotone frontier  — within one batch's computation, the affected set
      only grows;
  I4  fault-schedule soundness — crashed threads never participate again;
      delayed threads return; at least one thread participates in some sweep
      (lock-freedom's "some thread makes progress");
  I5  stability          — delete(B) then insert(B) returns the original
      edge set exactly (HostGraph functional-update correctness).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.core.graph import GraphSnapshot, HostGraph


def rank_conservation_error(g: GraphSnapshot, ranks: torch.Tensor) -> float:
    """|Σ ranks − 1|; near 0 at a fixed point of the self-loop system."""
    return float((ranks[:g.n_pad].sum() - 1.0).abs())


def marking_idempotent(g_prev: GraphSnapshot, g_cur: GraphSnapshot,
                       batch: torch.Tensor) -> bool:
    once = fr.initial_affected(g_prev, g_cur, batch)
    twice = once | fr.initial_affected(g_prev, g_cur, batch)
    return bool(torch.equal(once, twice))


def frontier_monotone(before: torch.Tensor, after: torch.Tensor) -> bool:
    return bool((~before | after).all())


def fault_schedule_sound(plan, horizon: int = 64) -> bool:
    crashed_stay_crashed = all(
        not np.any(plan.alive(t) & ~plan.alive(t - 1))
        for t in range(1, horizon))
    someone_progresses = any(plan.participating(t).any()
                             for t in range(horizon))
    return crashed_stay_crashed and someone_progresses


def delete_insert_roundtrip(hg: HostGraph, batch: np.ndarray) -> bool:
    """I5: removing then re-adding a batch restores the exact edge set."""
    present = hg.has_edges(batch)
    batch = batch[present]
    g2 = hg.apply_batch(batch, np.zeros((0, 2), np.int64))
    g3 = g2.apply_batch(np.zeros((0, 2), np.int64), batch)
    return bool(np.array_equal(hg.edges, g3.edges))


def ranks_match_reference(ranks, reference, *, tol: float) -> bool:
    """Paper §5.1.5: L∞ distance to the reference must stay below tol."""
    ranks = torch.as_tensor(ranks)
    reference = torch.as_tensor(reference, device=ranks.device)
    k = min(ranks.shape[0], reference.shape[0])
    return float((ranks[:k] - reference[:k]).abs().max()) <= tol
