"""Blocked frontier sweep engine — DF_BB / DF_LF by in-order Gauss–Seidel
sweeps (ports ``src/repro/core/blocked.py``).

Vertices are grouped into fixed blocks (the paper's chunks).  Each sweep:
  1. compacts the ids of *active* blocks (:func:`active_blocks`) and reads
     their count on the host — the static-shape analogue of the paper's
     dynamic work pool;
  2. walks the compacted slots in order (:func:`sweep`: one launch of the
     hand-written sweep kernel on the card, its plain version on the CPU).
     Per slot the block's in-edges are pulled, so work is proportional to
     the block's real edge count;
  3. LF mode (Gauss–Seidel): ranks are updated **in place**, later slots see
     earlier slots' fresh ranks within the same sweep — the lock-free
     asynchronous semantics.  BB mode (Jacobi): all reads come from a copy
     of the ranks taken before the sweep, and a barrier (global L∞) follows;
  4. if the rank of a vertex moves more than τ_f, its out-neighbours are
     OR-marked as affected (frontier expansion, edge-proportional);
  5. per-slot masks simulate delayed / crashed pseudo-threads: a masked slot
     does no work and its block simply stays flagged for a later sweep.

K, the number of slots a sweep walks, is drawn from the fixed ladder
:func:`slot_buckets` (recomputed every sweep, so capacity grows and shrinks
with the frontier).  α/τ/τ_f are kernel arguments: a hyperparameter sweep
builds nothing new.

This engine drives its loop from the host and reads three small values per
sweep (active count, per-slot edges, convergence test), as the reference
does.  It is the in-sweep Gauss–Seidel reference and fault-model oracle;
the card's main path is the fused driver of
:mod:`repro_torch.core.pallas_engine`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults as flt
from repro_torch.core import frontier as fr
from repro_torch.core.graph import GraphSnapshot
from repro_torch.kernels.blocked_sweep import blocked_sweep as bws


@dataclasses.dataclass
class SweepStats:
    sweeps: int = 0
    iterations: int = 0           # BB barrier iterations (== sweeps for LF)
    blocks_processed: int = 0
    edges_processed: int = 0
    sim_time_ms: float = 0.0
    converged: bool = False
    dnf: bool = False             # BB stalled at barrier due to a crash


def sweep_graph(g: GraphSnapshot, dtype) -> bws.SweepGraph:
    """The snapshot arrays a sweep reads, with the reciprocal out-degrees
    in ``dtype`` (0 on the padding and at the phantom entry ``n_pad``)."""
    deg = g.out_deg.clamp(min=1).to(dtype)
    inv = torch.where(g.vertex_valid, 1.0 / deg, torch.zeros_like(deg))
    return bws.SweepGraph(
        block=g.block_size, n_pad=g.n_pad, in_block_ptr=g.in_block_ptr,
        out_block_ptr=g.out_block_ptr, vptr=g.in_ptr, src=g.src, dst=g.dst,
        osrc=g.osrc, odst=g.odst, inv_deg=torch.cat([inv, inv.new_zeros(1)]),
        valid=g.vertex_valid)


def sweep(g: GraphSnapshot, R, affected, RC, slot_ids, slot_mask, R_read,
          alpha, tau, tau_f, *, tile: int, expand: bool, jacobi: bool):
    """One compacted sweep over up to K = len(slot_ids) active blocks.

    ``R`` [n_pad], ``affected`` and ``RC`` [n_pad + 1] (entry ``n_pad`` is the
    expansion's trash slot) are updated in place and returned; ``R_read`` is
    ``R`` in LF mode and a copy of ``R`` taken before the sweep in BB mode.
    Returns ``(R, affected, RC, maxdr, edges_per_slot)`` — ``maxdr`` a 0-d
    tensor, ``edges_per_slot`` [K] int32 (0 for masked or −1 slots).  The
    tensors' device picks the route: the CUDA kernel or its plain version."""
    maxdr, edges = bws.blocked_sweep(
        sweep_graph(g, R.dtype), R, R_read, affected, RC, slot_ids,
        slot_mask, n=g.n, alpha=alpha, tau=tau, tau_f=tau_f, tile=tile,
        expand=expand, jacobi=jacobi)
    return R, affected, RC, maxdr[0], edges


SLOT_BUCKET_BASE = 16
SLOT_BUCKET_GROWTH = 4


def slot_buckets(n_blocks: int) -> Tuple[int, ...]:
    """The full ladder of slot capacities ``run_blocked`` may ever use for a
    graph with ``n_blocks`` blocks: O(log n_blocks) values."""
    out = []
    K = SLOT_BUCKET_BASE
    while K < n_blocks:
        out.append(K)
        K *= SLOT_BUCKET_GROWTH
    out.append(n_blocks)
    return tuple(out)


def slot_capacity(n_act: int, n_blocks: int) -> int:
    """Smallest ladder bucket ≥ n_act (clamped to n_blocks).  Recomputed
    from the ladder base every sweep, so capacity *shrinks* as the frontier
    decays — a small late-phase frontier costs a small sweep."""
    for K in slot_buckets(n_blocks):
        if K >= n_act:
            return K
    return n_blocks


def active_blocks(flags: torch.Tensor, *, n_blocks: int, block_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact active block ids; returns (ids [n_blocks] w/ -1 fill, count)
    with the count on the device."""
    act = fr.block_any(flags, n_blocks, block_size)
    return fr.compact_block_ids(act, n_blocks), act.sum()


def run_blocked(g: GraphSnapshot, R0: torch.Tensor, affected0: torch.Tensor,
                *, mode: str = "lf", expand: bool = True,
                alpha: float = 0.85, tau: float = 1e-10,
                tau_f: Optional[float] = None, max_iterations: int = 500,
                tile: int = 512, faults: Optional[flt.FaultPlan] = None,
                active_policy: str = "affected", pager=None,
                ) -> Tuple[torch.Tensor, SweepStats]:
    """Driver loop: compaction → fault masking → sweep → convergence check.

    mode="lf": block-asynchronous Gauss–Seidel, per-vertex RC termination.
    mode="bb": Jacobi with a global L∞ barrier each iteration.

    active_policy selects which blocks a sweep processes:
      "affected" — every block containing an affected vertex (paper Alg. 2
                   line 19 verbatim);
      "rc"       — only blocks containing a not-yet-converged vertex (the
                   paper's per-chunk converged flag, §4.3).

    ``pager`` (the reference's tiered ``EdgePager``) is not ported yet."""
    if pager is not None:
        raise NotImplementedError(
            "run_blocked(pager=) is not ported yet: ROADMAP item A 10 "
            "(tiered storage) brings the EdgePager")
    if mode not in ("lf", "bb"):
        raise ValueError(mode)
    if active_policy not in ("affected", "rc"):
        raise ValueError(active_policy)
    jacobi = mode == "bb"
    if tau_f is None:
        tau_f = tau / 1000.0 if expand else float("inf")
    if not expand:
        tau_f = float("inf")
    plan = faults or flt.NO_FAULTS
    dtype = R0.dtype

    n_pad = g.n_pad
    valid = g.vertex_valid
    R = torch.where(valid, R0[:n_pad].to(g.device),
                    torch.zeros((), dtype=dtype, device=g.device))
    affected = torch.cat([affected0[:n_pad].to(g.device) & valid,
                          torch.zeros(1, dtype=torch.bool, device=g.device)])
    RC = affected.clone()
    stats = SweepStats()

    for it in range(max_iterations):
        act_flags = (affected if active_policy == "affected" else RC)
        ids_full, n_act = active_blocks(act_flags[:n_pad],
                                        n_blocks=g.n_blocks,
                                        block_size=g.block_size)
        n_act = int(n_act)
        if n_act == 0:
            stats.converged = True
            break
        # capacity-K compaction: the sweep walks K slots, K the smallest
        # ladder bucket ≥ |active|
        K = slot_capacity(n_act, g.n_blocks)
        ids = ids_full[:K]

        # dynamic scheduling (paper §3.3.2): compacted slots are drawn from a
        # global pool by the threads *participating* this sweep — a delayed or
        # crashed thread's work is picked up by the survivors (at the cost of
        # simulated time), never starved.
        if jacobi:
            # delayed threads still reach the barrier; crashes stall it
            if plan.any_crashed(it):
                stats.dnf = True
                break
            workers = np.arange(plan.n_threads)
        else:
            part = plan.participating(it)
            if not part.any():          # everyone asleep this sweep
                stats.sweeps += 1
                stats.sim_time_ms += plan.delay_ms
                continue
            workers = np.nonzero(part)[0]
        assign = workers[np.arange(K) % len(workers)]
        mask_np = np.arange(K) < n_act                # compacted real slots
        slot_mask = torch.as_tensor(mask_np, device=g.device)

        # in BB mode the sweep reads the sweep-start ranks: R is written in
        # place, so it reads a copy
        R_read = R.clone() if jacobi else R
        R, affected, RC, maxdr, edge_ct = sweep(
            g, R, affected, RC, ids, slot_mask, R_read, alpha, tau, tau_f,
            tile=tile, expand=expand, jacobi=jacobi)

        edges_np = edge_ct.cpu().numpy()
        thread_edges = np.bincount(assign[mask_np],
                                   weights=edges_np[mask_np],
                                   minlength=plan.n_threads)
        thread_blocks = np.bincount(assign[mask_np],
                                    minlength=plan.n_threads)
        stats.sim_time_ms += plan.sweep_time_ms(
            it, thread_edges, thread_blocks, barrier=jacobi)
        stats.sweeps += 1
        stats.iterations += 1
        stats.blocks_processed += int(mask_np.sum())
        stats.edges_processed += int(edges_np[mask_np].sum())

        if jacobi:
            if float(maxdr) <= tau:
                stats.converged = True
                break
        else:
            if not bool(RC[:n_pad].any()):
                stats.converged = True
                break

    return R[:n_pad], stats


# ---------------------------------------------------------------------------
# registry adapter (discovered lazily by repro_torch.api.registry)
# ---------------------------------------------------------------------------

class BlockedEngine:
    """Registry adapter for the blocked frontier sweep engine."""

    name = "blocked"
    fault_domains = ("thread", "process")

    def run(self, g, R0, affected0, *, mode, expand, alpha, tau, tau_f,
            max_iterations, faults, tile, active_policy,
            mat=None, aux=None, backend=None, shards=None):
        from repro_torch.api.registry import (reject_shard_spec,
                                              reject_tile_operands)
        reject_tile_operands(self.name, mat, aux, backend)
        reject_shard_spec(self.name, shards)
        return run_blocked(
            g, R0, affected0, mode=mode, expand=expand, alpha=alpha,
            tau=tau, tau_f=tau_f, max_iterations=max_iterations, tile=tile,
            faults=faults, active_policy=active_policy)


def as_engine() -> BlockedEngine:
    return BlockedEngine()
