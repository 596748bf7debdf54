"""Fused frontier engine — the DF_LF sweep loop on the card.

Ports ``src/repro/core/pallas_engine.py``: ``build_pull_matrix``,
``_driver`` (with the tiered session's ``rb_res``/``deferred`` operands
and the integrity invariants of the session's fused drive),
``_stats_from_vec``, ``run_pallas`` and the registry adapter
``PallasEngine`` / ``as_engine``.
The pull runs through the tile SpMV over compacted active row-blocks (sum
semiring, kernel #2), Dynamic Frontier expansion is the same kernel in the
OR semiring over the candidate row-blocks whose tiles meet a changed
column-block, and per-vertex τ/RC convergence, τ_f-gated expansion and the
thread-fault masks of :mod:`repro_torch.core.faults` are applied on the
device.  Within a sweep the update is block-Jacobi (every active block reads
the sweep-start ranks), as in the reference.

Sync contract.  The JAX driver is one ``lax.while_loop`` and syncs once per
drive.  Here the sweeps run eagerly in chunks of :data:`SWEEPS_PER_POLL`;
after each chunk the host reads one small vector (the counters and the
``converged | dnf | it ≥ max_iterations`` flag) — that read is the only
device-to-host transfer of a drive.  Every sweep body is gated on that flag
on the device exactly as the reference gates its body on ``cond``/``do``,
so the sweeps of a chunk that run past convergence change nothing, and
``sweeps / iterations / blocks / edges`` equal the reference's.  A drive
makes ``ceil(sweeps_run / SWEEPS_PER_POLL)`` host syncs (at least one); the
driver returns that count.  Whatever else a drive reports rides the same
read: a tiered session's deferral indicator, and with ``R_ref`` the four
integrity invariants of the iterate (``integrity.invariant_vec``), which
the reference fetches in its drive's single sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults as flt
from repro_torch.core import frontier as fr
from repro_torch.core import integrity as ig
from repro_torch.core.blocked import SweepStats
from repro_torch.core.graph import GraphSnapshot
from repro_torch.kernels.block_spmv import ops

SWEEPS_PER_POLL = 8


def build_pull_matrix(g: GraphSnapshot, dtype=torch.float64,
                      padded: bool = False) -> ops.BlockSparse:
    """Block-sparse pull matrix for a snapshot on the snapshot's device:
    A[v, u] = 1 iff edge u→v (self-loops included), padded to the snapshot's
    block grid.  ``padded=True`` preallocates the tile pool / slot tables on
    the growth ladder (streaming layout)."""
    src, dst = g.in_edges_host()
    return ops.build_block_sparse(dst, src, g.n_pad, g.n_pad,
                                  block=g.block_size, dtype=dtype,
                                  padded=padded, device=g.device)


def _driver(mat: ops.BlockSparse, R0, affected0, valid, out_deg, rb_in,
            rb_out, bmat, alpha, tau, tau_f, part_table, alive_table,
            delay_table, crashed_any, *, n: int, block_size: int, mode: str,
            expand: bool, active_policy: str, max_iterations: int,
            full: bool = False, rb_res: Optional[torch.Tensor] = None,
            tiered: bool = False, R_ref: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, np.ndarray, int]:
    """The fused loop.  Returns (ranks [n_pad], host stats vector [7],
    host syncs made).  ``alpha``/``tau``/``tau_f`` are 0-d tensors (runtime
    operands); the fault tables are tensors on the ranks' device.

    ``R_ref`` (the session's last verified iterate) stacks the four
    integrity invariants of the current iterate onto every poll's vector,
    four reductions over ``n_pad`` a chunk: the stats vector then holds
    ``7 + 4`` entries ahead of any tiered indicator, and the invariants are
    those of the returned ranks.

    ``tiered=True`` (:mod:`repro_torch.core.tiering`): ``mat`` is the hot
    slab's view and ``rb_res`` [n_rb] marks the resident row-blocks.  A
    non-resident block is never swept: seeds in it are deferred before the
    loop, and expansion candidates in it are deferred instead of pulled.
    The deferred indicator rides the poll — the stats vector then holds
    ``7 + n_rb`` entries, the last ``n_rb`` being the indicator (0/1) — so
    it costs no host sync of its own.

    ``full=True`` is the caller's promise that every row-block is active in
    every sweep — true of the all-affected solves (cold start, ``nd``,
    ``static``: ``affected`` policy, no expansion, every block holds a valid
    vertex).  The pull then runs the full-list kernel #1 and skips the
    compaction; a gated sweep after convergence still reads every tile, a
    cost of at most ``SWEEPS_PER_POLL - 1`` SpMVs per drive."""
    dev = R0.device
    dtype = R0.dtype
    B = block_size
    n_pad = valid.shape[0]
    n_rb = n_pad // B
    jacobi = mode == "bb"
    cdt = torch.float64          # counters: integer-exact to 2^53

    deg = out_deg.clamp(min=1).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inv_deg = torch.where(valid, 1.0 / deg, zero)
    base = ((1.0 - alpha) / n).to(dtype)
    alpha_c = alpha.to(dtype)
    tau_c = tau.to(dtype)
    tau_f_c = tau_f.to(dtype)
    n_threads = part_table.shape[1]
    rb_in_l, rb_out_l = rb_in.long(), rb_out.long()
    slot_thread = torch.arange(n_rb, device=dev)
    f_false = torch.zeros((), dtype=torch.bool, device=dev)

    def vexp(block_flags):
        return block_flags[:, None].expand(n_rb, B).reshape(-1)

    deferred = None
    R = torch.where(valid, R0[:n_pad], zero)
    affected = affected0[:n_pad] & valid
    if tiered:
        # seeds in non-resident blocks are deferred wholesale before the loop
        res_v = vexp(rb_res)
        deferred = fr.block_any(affected & ~res_v, n_rb, B)
        affected = affected & res_v
    RC = affected.clone()
    it = torch.zeros((), dtype=torch.long, device=dev)
    converged = f_false.clone()
    dnf = f_false.clone()
    sweeps = torch.zeros((), dtype=cdt, device=dev)
    iters = torch.zeros((), dtype=cdt, device=dev)
    blocks = torch.zeros((), dtype=cdt, device=dev)
    edges = torch.zeros((), dtype=cdt, device=dev)
    sim = torch.zeros((), dtype=torch.float32, device=dev)

    def sweep():
        nonlocal R, affected, RC, it, converged, dnf, deferred
        nonlocal sweeps, iters, blocks, edges, sim
        go = ~converged & ~dnf & (it < max_iterations)
        it_c = it.clamp(max=max_iterations - 1)
        act_flags = affected if active_policy == "affected" else RC
        act_rb = fr.block_any(act_flags, n_rb, B)
        n_act = act_rb.sum()
        no_work = n_act == 0

        if jacobi:
            participate = torch.ones(n_threads, dtype=torch.bool, device=dev)
            crash_now = go & crashed_any[it_c] & ~no_work
            asleep = f_false
        else:
            participate = part_table[it_c]
            crash_now = f_false
            asleep = go & ~participate.any() & ~no_work
        do = go & ~no_work & ~crash_now & ~asleep

        # -- compacted frontier sweep: pull over active row-blocks only ----
        ids = torch.where(do, fr.compact_block_ids(act_rb, n_rb), -1)
        n_eff = torch.where(do, n_act, 0)
        if full:
            pulled = ops.block_spmv(mat, R * inv_deg, semiring="sum")
        else:
            pulled = ops.block_spmv_active_bucketed(
                mat, R * inv_deg, ids, n_eff, semiring="sum")
        r_new = base + alpha_c * pulled
        upd = affected & vexp(act_rb) & valid & do
        r_fin = torch.where(upd, r_new, R)
        dr = torch.where(upd, (r_fin - R).abs(), zero)
        maxdr = dr.max()
        RC1 = torch.where(upd, dr > tau_c, RC)

        # -- DF expansion: OR semiring over candidate row-blocks ------------
        if expand:
            changed = upd & (dr > tau_f_c)
            ch_cb = fr.block_any(changed, n_rb, B)
            cand_rb = (bmat & ch_cb[None, :]).any(dim=1)
            if tiered:
                # candidates off the device: defer, never pull
                deferred = deferred | (cand_rb & ~rb_res & do)
                cand_rb = cand_rb & rb_res
            n_cand = torch.where(do, cand_rb.sum(), 0)
            cids = torch.where(do, fr.compact_block_ids(cand_rb, n_rb), -1)
            hitf = ops.block_spmv_active_bucketed(
                mat, changed.to(dtype), cids, n_cand, semiring="or")
            hit = (hitf > 0) & vexp(cand_rb) & valid & do
            affected1 = affected | hit
            RC1 = RC1 | hit
            out_rb = torch.where(ch_cb, rb_out_l, 0)
        else:
            affected1 = affected
            ch_cb = torch.zeros(n_rb, dtype=torch.bool, device=dev)
            out_rb = torch.zeros(n_rb, dtype=torch.long, device=dev)

        # -- work accounting + fault-time model (paper §5.1.6) --------------
        in_rb = torch.where(act_rb, rb_in_l, 0)
        e_sweep = torch.where(do, (in_rb + out_rb).to(cdt).sum(), 0)
        ids_c = ids.long().clamp(min=0)
        real_slot = ids >= 0
        slot_edges = torch.where(
            real_slot,
            rb_in_l[ids_c] + torch.where(ch_cb[ids_c], rb_out_l[ids_c], 0),
            0).to(torch.float32)
        # participating thread ids first, ascending (stable sort, no sync)
        pid = torch.argsort((~participate).to(torch.int8), stable=True)
        w = participate.sum().clamp(min=1)
        tid = pid[slot_thread % w]
        th_edges = torch.zeros(n_threads, dtype=torch.float32,
                               device=dev).index_add_(0, tid, slot_edges)
        th_blocks = torch.zeros(n_threads, dtype=torch.float32,
                                device=dev).index_add_(
            0, tid, real_slot.to(torch.float32))
        work_ms = (th_edges * flt.T_EDGE_NS
                   + th_blocks * flt.T_BLOCK_NS) * 1e-6
        delay_row = delay_table[it_c]
        alive = alive_table[it_c]
        fz = torch.zeros((), dtype=torch.float32, device=dev)
        if jacobi:
            step_ms = (work_ms + delay_row).max()
        else:
            step_ms = torch.where(
                asleep, torch.where(alive, delay_row, fz).max(),
                torch.where(alive, work_ms, fz).max())
        step_ms = torch.where(do | asleep, step_ms, fz)

        # -- convergence ----------------------------------------------------
        if jacobi:
            conv_after = do & (maxdr <= tau_c)
        else:
            # RC-empty is the paper's LF criterion; the maxdr escape stops
            # a float limit cycle (reference pallas_engine.py:230-239)
            conv_after = do & ((maxdr <= tau_c) | ~(RC1 & valid).any())

        R, affected, RC = r_fin, affected1, RC1
        converged = converged | (go & no_work) | conv_after
        dnf = dnf | crash_now
        sweeps = sweeps + (do | asleep).to(cdt)
        iters = iters + do.to(cdt)
        blocks = blocks + torch.where(do, n_act, 0).to(cdt)
        edges = edges + e_sweep
        sim = sim + step_ms
        it = it + go.to(torch.long)

    syncs = 0
    while True:
        for _ in range(SWEEPS_PER_POLL):
            sweep()
        done = converged | dnf | (it >= max_iterations)
        sv = torch.stack([sweeps, iters, blocks, edges, sim.to(cdt),
                          converged.to(cdt), dnf.to(cdt), done.to(cdt)])
        if R_ref is not None:
            sv = torch.cat([sv, ig.invariant_vec(R, R_ref, valid).to(cdt)])
        if tiered:
            sv = torch.cat([sv, deferred.to(cdt)])
        sv = sv.cpu().numpy()          # the poll: one sync per chunk
        syncs += 1
        if sv[7] > 0:
            return R, np.concatenate([sv[:7], sv[8:]]), syncs


def _stats_from_vec(sv: np.ndarray) -> SweepStats:
    return SweepStats(
        sweeps=int(sv[0]), iterations=int(sv[1]), blocks_processed=int(sv[2]),
        edges_processed=int(sv[3]), sim_time_ms=float(sv[4]),
        converged=bool(sv[5] > 0), dnf=bool(sv[6] > 0))


def run_pallas(g: GraphSnapshot, R0: torch.Tensor, affected0: torch.Tensor,
               *, mode: str = "lf", expand: bool = True,
               alpha: float = 0.85, tau: float = 1e-10,
               tau_f: Optional[float] = None, max_iterations: int = 500,
               faults: Optional[flt.FaultPlan] = None,
               active_policy: str = "affected",
               mat: Optional[ops.BlockSparse] = None,
               aux=None) -> Tuple[torch.Tensor, SweepStats]:
    """Fused-engine entry point; runs on the device of ``g``/``R0``.

    ``mat`` may be supplied (e.g. maintained incrementally across a stream
    by :class:`repro_torch.core.incremental.IncrementalPullMatrix`);
    otherwise it is built from the snapshot.  ``aux`` may carry the cached
    per-block vectors (``bmat`` / ``rb_in`` / ``rb_out``).
    """
    if mode not in ("lf", "bb"):
        raise ValueError(mode)
    if active_policy not in ("affected", "rc"):
        raise ValueError(active_policy)
    if tau_f is None:
        tau_f = tau / 1000.0 if expand else float("inf")
    if not expand:
        tau_f = float("inf")
    plan = faults or flt.NO_FAULTS
    dev = R0.device
    if mat is None:
        mat = build_pull_matrix(g, dtype=R0.dtype)
    elif mat.block != g.block_size or mat.n_rows != g.n_pad:
        raise ValueError(
            f"pull matrix grid (block={mat.block}, n_rows={mat.n_rows}) "
            f"does not match snapshot (block={g.block_size}, "
            f"n_pad={g.n_pad}); rebuild with build_pull_matrix")

    if aux is not None:
        rb_in = torch.as_tensor(aux.rb_in, device=dev)
        rb_out = torch.as_tensor(aux.rb_out, device=dev)
        bmat = torch.as_tensor(aux.bmat, device=dev)
    else:
        rb_in, rb_out = g.block_in_edges(), g.block_out_edges()
        bmat = ops.block_adjacency(mat)

    def f(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    part, alive, delay, crashed = (torch.as_tensor(a, device=dev)
                                   for a in plan.device_tables(
                                       max_iterations))
    # an all-active solve (checked once, before the loop) pulls with the
    # full-list kernel
    full = (active_policy == "affected" and not expand and bool(
        fr.block_any(affected0[:g.n_pad] & g.vertex_valid, g.n_blocks,
                     g.block_size).all()))
    R, sv, _ = _driver(
        mat, R0[:g.n_pad], affected0[:g.n_pad], g.vertex_valid, g.out_deg,
        rb_in, rb_out, bmat, f(alpha), f(tau), f(tau_f),
        part, alive, delay, crashed,
        n=g.n, block_size=g.block_size, mode=mode, expand=expand,
        active_policy=active_policy, max_iterations=max_iterations,
        full=full)
    return R[:g.n_pad], _stats_from_vec(sv)


# ---------------------------------------------------------------------------
# registry adapter (discovered lazily by repro_torch.api.registry, so this
# module never imports the api package)
# ---------------------------------------------------------------------------

class PallasEngine:
    """Registry adapter for the fused frontier engine.  ``mat`` / ``aux``
    carry the incrementally maintained pull matrix + per-block operands
    (:class:`repro_torch.core.incremental.IncrementalPullMatrix`); without
    them each call builds the pull matrix of ``g``.  The kernel is picked by
    the tensors' device, so ``backend`` must be ``None``."""

    name = "pallas"
    fault_domains = ("thread", "process", "corruption")

    def run(self, g, R0, affected0, *, mode, expand, alpha, tau, tau_f,
            max_iterations, faults, tile, active_policy,
            mat=None, aux=None, backend=None, shards=None):
        from repro_torch.api.registry import reject_shard_spec
        reject_shard_spec(self.name, shards)
        if backend is not None:
            raise ValueError(f"backend={backend!r}: the port's pallas engine "
                             "has no tile-backend switch; leave it None")
        del tile    # blocked-engine knob; the fused driver launches tiles
        return run_pallas(
            g, R0, affected0, mode=mode, expand=expand, alpha=alpha,
            tau=tau, tau_f=tau_f, max_iterations=max_iterations,
            faults=faults, active_policy=active_policy, mat=mat, aux=aux)


def as_engine() -> PallasEngine:
    return PallasEngine()
