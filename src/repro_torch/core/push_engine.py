"""Fused residual forward-push driver — work ∝ residual mass, not sweeps.

Ports ``src/repro/core/push_engine.py`` (``_push_driver`` with its tiered
mode, ``push_stats_from_vec``, ``residual_seed_host``, ``scatter_residual``,
``residual_full``, ``residual_refresh_blocks``, ``residual_from_host``).  The
session keeps a residual ``r`` next to the rank estimate ``p`` under the
exact invariant

    r = b + M·p − p,      b = (1−α)/n on valid vertices,
                          M = α · A · D⁻¹  (pull matrix, self-loops incl.)

and each sweep pushes the residual of the row-blocks that still hold an
entry above τ: ``p ← p + r·1_S``, ``r ← r − r·1_S + α·A·D⁻¹·(r·1_S)``.  The
push is kernel #2 in the ``sum`` semiring on the pull tile layout
(:func:`repro_torch.kernels.block_spmv.ops.block_spmv_push_bucketed`: the
operand masked to the selected source column-blocks, the launch over the
candidate destination row-blocks); the exact rebuild :func:`residual_full`
is one launch of kernel #1.

Sync contract, as :mod:`repro_torch.core.pallas_engine`'s: sweeps run in
chunks of :data:`~repro_torch.core.pallas_engine.SWEEPS_PER_POLL`, each
chunk ends in one read of a small vector (:func:`_poll`), and every sweep
body is gated on ``~converged & ~stalled & it < max_iterations`` as the
reference gates its body on ``cond``, so the sweeps that run past
convergence change nothing and the counters equal the reference's.

Tiered storage composes without a mid-sweep sync: on the hot slab's view
a push delivers to resident destination row-blocks only, and a pushed-to
non-resident block goes stale and is marked in a deferred indicator that
rides the chunk's poll.  ``p`` stays exact everywhere (advancing it needs no
tiles), so the session's refill loop admits the stale blocks and rebuilds
their residual exactly from the invariant (:func:`residual_refresh_blocks`,
one launch of kernel #2 over the admitted blocks' own tile rows).

``push_cache_size`` has no counterpart: the session counts kernel builds
instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.core.blocked import SweepStats
from repro_torch.core.graph import HostGraph
from repro_torch.core.pallas_engine import SWEEPS_PER_POLL
from repro_torch.kernels.block_spmv import ops

# stats vector layout returned by _push_driver
STATS_LEN = 8   # sweeps, pushed_blocks, cand_blocks, edges, l1, maxr,
#                 converged, stalled


def _poll(sv: torch.Tensor) -> np.ndarray:
    """The driver's one device-to-host read per chunk."""
    return sv.cpu().numpy()


def _push_driver(mat: ops.BlockSparse, P0, R0, valid, out_deg, bmat, alpha,
                 tau, *, n: int, block_size: int, max_iterations: int,
                 rb_res: Optional[torch.Tensor] = None, tiered: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, int]:
    """The fused push loop.  Returns (p [n_pad], r [n_pad], host stats
    vector [STATS_LEN], host syncs made).

    ``P0`` is the rank estimate and ``R0`` the residual satisfying
    ``r = b + M·p − p`` (the caller keeps it by seeding or a full rebuild);
    ``alpha``/``tau`` are 0-d tensors (runtime operands).

    ``tiered=True``: ``mat`` is the hot slab's view and ``rb_res`` [n_rb]
    marks the resident row-blocks.  Pushes deliver to resident candidate
    destination blocks only; a candidate off the device goes stale and is
    marked in ``deferred``, which rides the poll — the stats vector then
    holds ``STATS_LEN + n_rb`` entries, the last ``n_rb`` the indicator
    (0/1) — so it costs no host sync of its own."""
    dev = P0.device
    dtype = P0.dtype
    B = block_size
    n_pad = valid.shape[0]
    n_rb = n_pad // B
    cdt = torch.float64          # counters: integer-exact to 2^53
    eps = float(torch.finfo(dtype).eps)

    zero = torch.zeros((), dtype=dtype, device=dev)
    deg = out_deg.clamp(min=1).to(dtype)
    inv_deg = torch.where(valid, 1.0 / deg, zero)
    alpha_c = alpha.to(dtype)
    tau_c = tau.to(dtype)
    base_floor = (1.0 - alpha_c) / n
    out_deg_c = out_deg.to(cdt)

    def vexp(block_flags):
        return block_flags[:, None].expand(n_rb, B).reshape(-1)

    P = torch.where(valid, P0[:n_pad], zero)
    Rr = torch.where(valid, R0[:n_pad], zero)
    f_false = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.long, device=dev)
    converged, stalled = f_false.clone(), f_false.clone()
    sweeps, pushed_b, cand_b, edges = (
        torch.zeros((), dtype=cdt, device=dev) for _ in range(4))
    deferred = torch.zeros(n_rb, dtype=torch.bool, device=dev)

    def sweep():
        nonlocal P, Rr, it, converged, stalled, sweeps, pushed_b, cand_b
        nonlocal edges, deferred
        go = ~converged & ~stalled & (it < max_iterations)
        aRr = Rr.abs()
        rb_maxr = aRr.reshape(n_rb, B).amax(dim=1)
        maxr = rb_maxr.max()
        # ulp-floor escape: every remaining residual is below the rounding
        # granularity of p, so pushing cannot move p
        at_floor = maxr <= 16.0 * eps * torch.maximum(P.abs().max(),
                                                      base_floor)
        # per-vertex exit: pushing v moves p[v] by exactly r[v], the same
        # strength as the pull driver's maxdr ≤ tau stop
        conv_now = (maxr <= tau_c) | at_floor
        pushable = rb_maxr > tau_c
        n_push = pushable.sum()
        do = go & ~conv_now & (n_push > 0)
        # defensive, as the reference: maxr > tau with no block above tau
        # cannot happen
        stall_now = go & ~conv_now & (n_push == 0)

        # The reference selects the top-K blocks by residual mass, K the
        # smallest rung of a size ladder ≥ |pushable| (a lax.switch that
        # keeps the TPU trace static).  Every pushable block has mass
        # ≥ max|r| > tau > 0 and K ≥ |pushable|, so that selection is
        # exactly the pushable set: no top-k, and no read of n_push.
        sel = pushable & do

        # -- the push: per-vertex threshold (only |r| > tau moves), kernel
        #    #2 over the candidate destination row-blocks ----------------
        sel_v = vexp(sel) & valid & (aRr > tau_c)
        cand = (bmat & sel[None, :]).any(dim=1)
        if tiered:
            # deliver to resident destination blocks only; a pushed-to
            # block off the device goes stale (sel is zero on a gated
            # sweep, so cand carries the gate)
            deferred = deferred | (cand & ~rb_res)
            cand = cand & rb_res
        n_cand = torch.where(do, cand.sum(), 0)
        cids = torch.where(do, fr.compact_block_ids(cand, n_rb), -1)
        moved = torch.where(sel_v, Rr, zero)
        pushed = ops.block_spmv_push_bucketed(mat, moved * inv_deg, sel, cids,
                                              n_cand)
        # rows outside the launch list are undefined: mask before the add
        pushed = torch.where(vexp(cand) & valid & do, pushed, zero)
        P = P + moved
        Rr = Rr - moved + alpha_c * pushed

        # edge work = out-edges of the vertices actually pushed this sweep
        edges = edges + torch.where(sel_v, out_deg_c, 0).sum()
        sweeps = sweeps + do.to(cdt)
        pushed_b = pushed_b + torch.where(do, n_push, 0).to(cdt)
        cand_b = cand_b + n_cand.to(cdt)
        converged = converged | (go & conv_now)
        stalled = stalled | stall_now
        it = it + go.to(torch.long)

    syncs = 0
    while True:
        for _ in range(SWEEPS_PER_POLL):
            sweep()
        done = converged | stalled | (it >= max_iterations)
        aR = Rr.abs()
        sv = torch.stack([
            sweeps, pushed_b, cand_b, edges, aR.sum().to(cdt),
            aR.max().to(cdt), converged.to(cdt), stalled.to(cdt),
            done.to(cdt)])
        if tiered:
            sv = torch.cat([sv, deferred.to(cdt)])
        sv = _poll(sv)
        syncs += 1
        if sv[STATS_LEN] > 0:
            return P, Rr, np.delete(sv, STATS_LEN), syncs


def push_stats_from_vec(sv: np.ndarray) -> Tuple[SweepStats, dict]:
    """Split the driver's stats vector into the engine-common
    :class:`SweepStats` plus the push-specific extras."""
    stats = SweepStats(
        sweeps=int(sv[0]), iterations=int(sv[0]),
        blocks_processed=int(sv[2]), edges_processed=int(sv[3]),
        sim_time_ms=0.0, converged=bool(sv[6] > 0), dnf=False)
    extras = {"pushed_blocks": int(sv[1]),
              "residual_l1": float(sv[4]),
              "max_residual": float(sv[5]),
              "stalled": bool(sv[7] > 0)}
    return stats, extras


# ---------------------------------------------------------------------------
# residual maintenance: O(batch·deg) delta seeding + full recompute
# ---------------------------------------------------------------------------

def residual_seed_host(hg_prev: HostGraph, hg_cur: HostGraph,
                       sources: np.ndarray, p_src: np.ndarray,
                       deg_old: np.ndarray, deg_new: np.ndarray,
                       alpha: float) -> Tuple[np.ndarray, np.ndarray]:
    """Exact residual shift for one delta batch, enumerated host-side.

    A batch changes M → M' only in the columns of its (effective) source
    vertices, so ``Δr = (M' − M)·p`` is, per source u:

        r[v] −= α·p[u]/deg_old(u)   for v ∈ N_old(u) ∪ {u}
        r[v] += α·p[u]/deg_new(u)   for v ∈ N_new(u) ∪ {u}

    (the ∪{u} term is the per-vertex self-loop every device graph
    carries; ``deg_*`` already count it).  Neighbor lists come from the
    sorted host key sets — O(batch·deg) work, no snapshot.  Returns a
    flat (indices, values) scatter list for :func:`scatter_residual`."""
    sources = np.asarray(sources, np.int64).reshape(-1)
    p_src = np.asarray(p_src)
    idx_parts, val_parts = [], []
    for hg, deg, sgn in ((hg_prev, deg_old, -1.0), (hg_cur, deg_new, 1.0)):
        n = np.int64(hg.n)
        keys = hg._keys
        lo = np.searchsorted(keys, sources * n)
        hi = np.searchsorted(keys, (sources + 1) * n)
        counts = (hi - lo).astype(np.int64)
        total = int(counts.sum())
        flat = np.empty(total, np.int64)
        off = 0
        for k0, k1 in zip(lo.tolist(), hi.tolist()):
            if k1 > k0:
                flat[off:off + (k1 - k0)] = keys[k0:k1] % n
                off += k1 - k0
        scale = (sgn * alpha) * p_src / np.maximum(
            np.asarray(deg, p_src.dtype), 1)
        idx_parts += [flat, sources]
        val_parts += [np.repeat(scale, counts), scale]
    return (np.concatenate(idx_parts),
            np.concatenate(val_parts).astype(p_src.dtype))


def scatter_residual(Rr: torch.Tensor, idx: np.ndarray, vals: np.ndarray
                     ) -> torch.Tensor:
    """``Rr`` plus a host-enumerated residual shift, as a new tensor,
    deterministic on the card.

    Duplicate indices are grouped on the host by occurrence: round j adds
    the j-th occurrence of every index, so the indices of a round are
    unique and each round is a gather, an add and a scatter with no two
    writes to one element (no floating-point atomics).  Every element
    receives its terms in list order, as a sequential scatter (and the
    reference's) adds them.  The rounds number the largest multiplicity in
    the list; the lists cross to the device once, without a host sync."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    vals = np.asarray(vals).reshape(-1)
    out = Rr.clone()
    if not len(idx):
        return out
    order = np.argsort(idx, kind="stable")
    s = idx[order]
    pos = np.arange(len(s))
    first = np.maximum.accumulate(
        np.where(np.r_[True, s[1:] != s[:-1]], pos, 0))
    rank = np.empty(len(idx), np.int64)
    rank[order] = pos - first                    # occurrence number
    perm = np.argsort(rank, kind="stable")       # list order within a round
    bounds = np.r_[0, np.cumsum(np.bincount(rank))].tolist()
    idx_d = ops._upload(idx[perm], Rr.device)
    val_d = ops._upload(torch.from_numpy(vals[perm]).to(Rr.dtype),
                        Rr.device)
    for a, b in zip(bounds[:-1], bounds[1:]):
        ii = idx_d[a:b]
        out[ii] = out[ii] + val_d[a:b]
    return out


def residual_full(mat: ops.BlockSparse, P, valid, out_deg, alpha, *,
                  n: int) -> torch.Tensor:
    """Full residual recompute on the device matrix:
    ``r = b + α·A·D⁻¹·p − p`` (the nd / given-ranks path — O(m), exact, no
    seeding history needed): one launch of kernel #1 on the card."""
    dtype = P.dtype
    zero = torch.zeros((), dtype=dtype, device=P.device)
    deg = out_deg.clamp(min=1).to(dtype)
    inv_deg = torch.where(valid, 1.0 / deg, zero)
    alpha_c = alpha.to(dtype)
    base = (1.0 - alpha_c) / n
    Pm = torch.where(valid, P, zero)
    pulled = ops.block_spmv(mat, Pm * inv_deg, semiring="sum")
    return torch.where(valid, base + alpha_c * pulled - Pm, zero)


def residual_refresh_blocks(mat: ops.BlockSparse, P, Rr, valid, out_deg,
                            alpha, ids, n_ids, *, n: int, block_size: int
                            ) -> torch.Tensor:
    """Exact residual rebuild restricted to the listed row-blocks:
    ``r[rb] = b + α·(A·D⁻¹·p)[rb] − p[rb]`` for each id, ``Rr`` elsewhere
    (the tiered refill path: a stale, just-admitted block needs only its
    own tile row, and ``p`` is always exact).  ``ids`` is a [n_rb]
    −1-padded compact list and ``n_ids`` its int64 count on the device:
    one ``sum`` launch of kernel #2 on the card, never a host read."""
    dtype = P.dtype
    n_rb = valid.shape[0] // block_size
    zero = torch.zeros((), dtype=dtype, device=P.device)
    deg = out_deg.clamp(min=1).to(dtype)
    inv_deg = torch.where(valid, 1.0 / deg, zero)
    alpha_c = alpha.to(dtype)
    base = (1.0 - alpha_c) / n
    Pm = torch.where(valid, P, zero)
    pulled = ops.block_spmv_active_bucketed(mat, Pm * inv_deg, ids, n_ids,
                                            semiring="sum")
    sel = torch.zeros(n_rb + 1, dtype=torch.bool, device=P.device)
    sel[torch.where(ids >= 0, ids.long(), n_rb)] = True
    rows = sel[:n_rb, None].expand(n_rb, block_size).reshape(-1) & valid
    return torch.where(rows, base + alpha_c * pulled - Pm, Rr)


def residual_from_host(hg: HostGraph, out_deg: np.ndarray, p: np.ndarray,
                       alpha: float) -> np.ndarray:
    """Full residual recompute from host truth, self-loops added explicitly:
    a tiered session's rebuild (its device matrix is only the slab's view)
    and the invariant oracle of the tests and of ``chip_smoke.py``."""
    n = hg.n
    keys = hg._keys
    src = (keys // n).astype(np.int64)
    dst = (keys % n).astype(np.int64)
    p = np.asarray(p)
    deg = np.maximum(np.asarray(out_deg[:n], np.float64), 1)
    contrib = float(alpha) * np.asarray(p[:n], np.float64) / deg
    pulled = np.bincount(dst, weights=contrib[src], minlength=n)
    pulled += contrib           # the per-vertex self-loops
    r = (1.0 - float(alpha)) / n + pulled - np.asarray(p[:n], np.float64)
    out = np.zeros(p.shape[0], p.dtype)
    out[:n] = r.astype(p.dtype)
    return out
