#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Phases, each of which raises (non-zero exit) on any failed check:

1. device and build: the card's name and power limit, the CUDA kernels
   built from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per source,
   started together);
2. kernel parity: each kernel (reading the packed nonzero index) against
   its plain PyTorch version (reading the dense tiles) on the card (sum and
   or semirings; f32, f64, bf16; B = 8, 64, 128; exact and padded layouts
   and after an ``apply_delta``; the active kernel into a NaN-poisoned
   output buffer, and a fused drive whose active-kernel outputs are all
   poisoned must equal the clean drive exactly); then, after each batch of
   a delta stream whose index refreshes and compacts, both kernels again,
   two launches bit-identical, a −1 in the middle of the active list and a
   device count ``n_active`` shorter than the list;
3. main path: ``PageRankSession.from_graph`` over ``grid_road(1024)``
   (n = 1,048,576, a road network) in f64 at B = 64 with its cold solve,
   ``warmup()``, 8 ``df`` updates of ``random_batch(frac=1e-4,
   deletions_frac=0.2)``, one ``nd`` update (the paper's warm-start
   baseline), then ``top_k(10)`` and a ``query``; the launch counters are
   zeroed just before and read just after; the final ranks are held to the
   port's ``numpy_reference`` on the final graph;
4. each kernel held to its plain version at the main path's shapes (the
   or semiring of the active kernel too) and timed beside its bound (the
   fewest bytes of the work over two encodings — CSR, or each nonzero's
   value and 2-byte in-tile place with 8 bytes per live tile — plus x and
   y, and its flops), the bytes the dense tiles would move
   (``layout_bytes``), its plain version and the ``torch.sparse`` CSR
   product of the same matrix; then one forced compaction of the packed
   index at that size, timed, with how many df updates the tail's room
   lasts;
5. one more df update under ``cProfile``: where its wall time goes; and
   one under ``torch.profiler``: the card's busy time in it (the sum of its
   kernels' device time) against its wall time, i.e. the idle share;
6. the push driver (``EngineConfig(driver="push")``) on the same graph and
   traffic, after the pull session is closed: its cold solve, ``warmup()``,
   the same 8 df batches and nd batch, ``top_k(10)`` and a ``query``, with
   the launch counters zeroed just before and read just after; per update
   its sweeps, pushed and candidate blocks, edges and host syncs beside the
   pull's; the final ranks held to phase 3's oracle (≤ 1e-8) and the
   residual to the invariant rebuilt on the host (≤ 1e-12); one more df
   update whose drive is replayed from the same (p, r) state, clean (bit
   for bit) and with every active-kernel output poisoned (bit for bit); the
   first push launch of kernel #2 of that drive held to its plain version
   and timed beside its bound and ``torch.sparse``; and the phase-5
   profiles of one more push df update;
7. the paper's variant matrix on the same graph, after the push session is
   closed, with the launch counters zeroed just before and read just
   after: a fresh pull session takes two ``dt`` updates (per update the
   vertices DT marked against DF's initial set for the same batch, the BFS
   hops, host syncs, sweeps, edges), then ``recompute("df")`` and
   ``recompute("dt")`` (the ``dt`` replay must equal the last update bit
   for bit), all held to the oracle of the final graph; then snapshot
   mode: ``df_pagerank`` on one more batch with the helping marking (a
   third of the batch in the first pass) and fault-free — equal affected
   sets, both held to the oracle — and a cold solve of the ``dense``
   engine (BB) on the same snapshot, held to the same oracle;
8. the blocked Gauss–Seidel engine on phase 3's final graph, with the
   launch counters zeroed just before and read just after: a cold
   ``static_pagerank(mode="lf", engine="blocked")`` held to phase 3's
   oracle; three snapshot-mode blocked sessions (fault-free, ``faults=`` a
   plan with 48 of 64 threads crashed, and ``fault_domain=`` the thread
   domain of the same plan) each taking the same two df batches — the two
   faulted ones bit-identical — held to ``reference_pagerank`` of the final
   graph; then ``df_pagerank`` on the second batch: the dense engine's LF
   mode (bit-identical to the session's update), LF under the crash plan,
   BB on the blocked and the pallas engine — ``nd_pagerank`` (no
   expansion: sweeps, blocks and edges equal) and ``df_pagerank`` (its
   counters printed side by side: ROADMAP C 7) — and BB under one crash
   (dnf); per solve its sweeps, blocks, edges and the sweep kernel's device
   time, each solve's counters (sweeps, blocks, edges, ``sim_time_ms``)
   equal to fixed values (``BLOCKED_COUNTERS``: the sweep is exact, so no
   kernel may move them).  Then the sweep kernel against its plain
   version (LF and BB, on the card; three more LF launches bit-identical to
   the first) over all 16,384 slots of a cold start, over the compacted DF
   frontier of the first batch, and over a chain of 2,048 adjacent blocks
   from the frontier's first (each slot reads the last one's fresh ranks
   and marks the next), timed beside its bound.  Then the paged run: a DF solve (LF, ``active_policy="rc"``) of 16
   local insertions, unpaged, then through a pager holding every block
   with each sweep's active set recorded, and through an ``EdgePager``
   whose budget holds the largest of those sets and no more (below the
   snapshot's edge bytes) over ``paged_snapshot``: bit-equal, with misses; its pager counters and ms a sweep beside the
   unpaged; and the paged sweep kernel on the first active set against its
   plain version and, bit for bit, against the unpaged kernel;
9. durability on phase 3's graph and batches, with the launch counters
   zeroed just before the restore and read at the end: a child process
   (``chip_smoke.py --durable-child DIR``) opens phase 3's session durable
   (``checkpoint_interval=3``), warms up, takes the first 4 df batches and
   is SIGKILLed; ``PageRankSession.restore`` (checkpoint 3 + 1 WAL batch)
   must equal phase 3's ranks after update 4 bit for bit, launch
   ``block_spmv_active`` in the replay, stream batches 5–8 to phase 3's
   ranks after update 8 bit for bit and build no kernel; a ``fork`` given
   phase 3's nd batch equals phase 3 bit for bit while the parent stays as
   it was (and then equals the fork given the same batch); the store
   reopened without durability (the parent's nd update was batch 9, so
   checkpoint 9) equals phase 3's nd update bit for bit, and a ``save`` of
   that non-durable session restores bit for bit.  It prints the durable open,
   the WAL's cost per record (a durable ``update()`` minus its step, in ms,
   and the record's bytes), the durable df p50 beside
   phase 3's, the checkpoint's bytes and seconds, the restore's
   ``recovery_time_s`` and ``replayed_batches``, and the fork's ms and
   device-memory delta;
10. the tiered pull path (``EngineConfig(device_budget_bytes=...)``) on
   phase 3's graph and batches, with the launch counters zeroed just
   before and read at the end: a session at half the host pool's bytes
   (in the reference's dense-tile units, so its ~131,100 slab slots hold
   fewer than the 132,245 live tiles) opens with a tiered cold solve that
   must evict and refill, takes the 8 ``df`` batches and the ``nd`` batch
   (every update converged, no ``SweepCapWarning``, within 1e-8 of phase
   3's ranks and oracle, no dense tile on the card), is saved and
   restored untiered and under the full budget (bit-equal) and forked (the
   parent's next batch leaves the child alone); a full-budget session
   warm-starts from phase 3's opening ranks and takes the same batches. It
   prints the card memory beside phase 3's session's, the host pool's bytes
   and build time, the cold solve's refill rounds, ``df`` p50/p95, host
   syncs and host admission time per update, ``report().device_bytes`` and
   ``report().tiering``;
11. the tiered push path (``driver="push"`` with ``device_budget_bytes``
   half the host pool's bytes) on phase 3's graph and batches, after phase
   10's sessions are closed, with the launch counters zeroed just before
   and read at the end: a session warm-started from phase 3's opening
   ranks (its residual rebuilt from host truth, so no cold solve) takes
   the 8 ``df`` batches and the ``nd`` batch (every update converged, no
   ``SweepCapWarning``, within 1e-8 of phase 6's push ranks and of phase
   3's oracle, the residual within 1e-12 of host truth after the last
   batch). It prints per update the wall, sweeps, pushed blocks, edges,
   host syncs and refill rounds, ``df`` p50/p95 beside phase 6's, the card
   memory beside phase 6's session, ``report().device_bytes`` and
   ``report().tiering``;
12. integrity (``EngineConfig(integrity=...)``, the corruption domain)
   after phase 11, with the launch counters zeroed just before and read at
   the end: a durable session with ``mass_tol = n·τ`` and
   ``auto_repair=False`` streams phase 3's df batches (the same host syncs
   as phase 3, ranks within 1e-8 of phase 3's); a clean deep ``verify()``
   is timed and split into its parts; each corruption kind (``rank``,
   ``tile``, ``slot``, ``mirror``, ``scatter_drop``, ``scatter_dup`` —
   these two tear the update after them — and ``graph``) is injected and
   must be found by its check and healed at its rung (``frontier`` for
   ``rank``, ``restore`` for ``graph``, ``rebuild`` otherwise) with
   ``block_spmv_active`` launched in the repair, then verify clean within
   1e-8 of phase 3's ranks (each rung timed alone and with its re-check);
   one more ``df`` update of that session under ``cProfile``; a deferred
   ``tile`` meets the fused gate of an
   auto-repairing session (printed whether it flagged) and must end
   clean; phase 10's half-budget tiered session, kept open, verifies clean
   (timed, its slab scrub apart) and heals a ``rank`` flip at
   ``frontier``;
13. serving (``PageRankService``) after phase 12, with the launch counters
   zeroed just before and read at the end: a lone session streams phase
   3's 8 ``df`` batches and 8 more (its ranks after 8 must equal phase 3's
   bit for bit), then its read view and a ``fork()`` are timed; a
   synchronous service over a durable slot and an ``integrity=`` slot
   (its card memory beside two sessions') streams the 8 batches with
   ``coalesce=False`` (both slots bit-equal to the lone run, no request
   error, no retry, no dead slot), scrubs a ``rank`` flip at ``frontier``
   and runs one background scrub; a background service over two fresh
   slots on their own CUDA streams (a durable one killed after 3
   dispatches and failed over by the watchdog, a plain one) streams all
   16 batches per slot while 3 reader threads read (both slots end
   bit-equal to the lone run, every read bit-equal to the lone run at its
   view's batch index, every staleness within the budget); idle reads are
   timed; a service opened from the host graph folds phase 3's 9 batches
   into one coalesced dispatch, within 1e-8 of phase 3's oracle;
14. the walk engine and PPR on phase 3's graph (R = 16, L = 48, f64):
   the device cipher against the plain threefry on 10^6 (seed, wid) pairs,
   ``walk_regen`` on 4,096 walks through the degree-7 vertices (their rows
   reversed), ``walk_touch`` on one batch's touched set, ``walk_regen`` on
   the walks that batch flags (on the open's adjacency: rows rewritten as
   they were) and over every walk (the open's regeneration), each equal to
   its plain version and timed beside its bound (the cipher's: one block
   a walk's key, two a step that continues it, one the step that ends
   it); then, with the launch counters
   zeroed just before and read at the end, a walk session opens, warms up
   and takes phase 3's 8 ``df`` batches and its ``nd`` batch (no build
   after warmup, each update delta-localized), equals a fresh store on the
   final graph, is restored exactly by a delete and reinsert of 64 edges,
   lies within L1 0.2 of phase 3's oracle, serves ``ppr_query`` equal to a
   numpy fold of the seeds' rows (ties lower id first) and saves and
   restores bit for bit; a one-slot walk service takes the 8 batches and
   serves degraded ``ppr_query`` reads equal to the lone session's at the
   view's batch index, its read view's refresh timed;
15. the sharded session (``EngineConfig(topology="sharded", n_shards=8)``,
   8 logical shards on the card) on phase 3's graph and batches, with the
   launch counters zeroed just before and read at the end: a contiguous
   ``full``-exchange session opened cold (within 1e-8 of phase 3's
   opening ranks; a ``recompute("static")`` repeats it bit for bit and
   gives its sweeps), phase 3's 8 ``df`` batches (each within 1e-8 of
   phase 3's ranks after the same batch, kernel #1 launched exactly 16
   times a sweep and kernel #2 never), ``recompute("df")`` bit-equal to
   the last update, the ``nd`` batch (within 1e-8 of phase 3's and its
   oracle); one shard's matrix through kernel #1 (``sum`` ≤ 1e-12, ``or``
   exact) against its plain version, timed beside its bound (launches not
   counted); the same stream under the ``delta`` exchange (the session's
   capacity, 1024), bit-equal to ``full`` with equal sweeps, and two
   ``DistRuntime``s (``full``, and ``delta`` at capacity 4096) driven
   through the same batches on the contiguous relabeling, bit-equal with
   equal sweeps and the sweeps that took the delta path counted; ``bf16`` and
   ``delta`` at the CPU tests' size (``tests/test_distributed.py``'s
   rmat(10) batch, 8 shards) on the card and on the CPU, and ``bf16`` at
   n = 1M (f32, τ = 1e-7, a static solve of phase 3's final graph: sweeps,
   L1 and L∞ to the oracle); ``hash`` and ``bfs_blocks`` sessions opened
   from phase 3's opening ranks and given batch 1 (within 1e-8 of the
   contiguous run; edge cut, live tiles per shard, card memory, the
   partition's seconds);
16. the sharded fault path in phase 15's setting (8 contiguous shards,
   ``full``), with the launch counters zeroed just before and read at the
   end: a session opened from phase 3's opening ranks takes phase 3's 8
   ``df`` batches while shard 3 is lost after 2 sweeps of batch 3 (helped,
   then re-partitioned onto 7 shards: one shard recovery with
   ``helped_vertices > 0``, no build), shard 2 stalls on batch 6 (no
   shrink) and a stale ``ShardFault(7)`` is dropped on batch 7; every
   batch within 1e-8 of phase 15's unfaulted ranks after it, the last of
   phase 3's; the faulted batch's sweeps, host syncs, kernel #1 launches
   (16 a sweep before the crash, 14 after), the recovery's seconds and the
   card's peak memory across the shrink are printed.  A durable 8-shard
   session (checkpoint every 3 batches) takes 4 batches and is dropped
   without ``close()``; its store restores onto 8 shards (within 1e-12 of
   the live ranks, bit for bit or not), onto 4 (1e-8) and onto one device
   with the pallas engine (1e-8), each replaying one batch.  An
   ``integrity=`` sharded session verifies clean with the 4 rank
   invariants and refuses a ``tile`` corruption with ``ValueError``;
17. the GNN model zoo at the registry's published widths on synthetic data
   from a seed (no hand-written kernel: message passing is
   ``index_select`` / ``index_add_``, the products ``torch.matmul`` with
   TF32 off; the kernel counters are zeroed before and must read 0
   after): (a) GraphSAGE ``minibatch_lg`` — a ``NeighborSampler`` over
   ``gnn_full_graph_batch``'s graph (n = 232,965, m = 114,615,892) and 5
   minibatches of ``graphsage_minibatch_stream`` (1,024 seeds, fanouts 15
   and 10, d_feat 602) through ``forward_sampled`` and
   ``loss_fn_sampled``; (b) the DF-incremental GraphSAGE update at
   ``ogb_products`` (n = 2,449,029, e = 61,859,140, d_feat 100): one full
   pass, then 3 batches of 6,186 edges rewired in place at τ_f = 1e-3,
   each with a τ_f = 0 update equal to a full recompute (rtol 1e-5, atol
   1e-6), the first batch's τ_f = 1e-3 update held to the same update on
   the CPU (its output, and its stats equal), the affected fraction per
   layer and the peak card memory; (c)
   every family's forward and loss at ``full_graph_sm`` at its full config,
   and egnn at ``molecule`` (128 graphs of 30 nodes, ``graph_reg``).  Every
   output is held to the same function on the CPU (f64 for (a) and (c),
   f32 for (b)) at the tolerance its line prints; each line prints the
   forward's CUDA-event median of 5 and its device time split by
   ``torch.profiler`` into gather, scatter, matmul and other beside its
   share of the wall, marked "partial" where no two traces in a row agreed
   or a device-bound call's kernels cover under 80 % of its wall.

The kernel JSON line's ``launches`` add the pull path's (phase 3), the
push path's (phase 6), the variant matrix's (phase 7), the blocked
path's (phase 8), the durable path's (phase 9), the tiered path's
(phase 10), the tiered push path's (phase 11), the integrity path's
(phase 12), the serving path's (phase 13), the walk path's (phase 14;
the walk kernels run only there), the sharded path's (phase 15) and the
sharded fault path's (phase 16); the GNN path (phase 17) launches none.
Prints the kernel table as one JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12                # H100 SXM FP64 outside the tensor cores
# H100 SXM INT32: 64 INT32 lanes a SM, half the 128 FP32 lanes behind the
# data sheet's 67 TFLOP/s (which counts an FMA as two operations)
INT32_OPS = 16.7e12
SIDE = 1024                      # grid_road(1024): n = 1,048,576
BLOCK = 64
TAU = 1e-10
N_DF_UPDATES = 8
N_DT_UPDATES = 2
TIERED_MAX_ITERATIONS = 4000     # phase 10: refill rounds of the cold solve
HOLD_CYCLES = 200_000_000        # ≥ 80 ms at the H100's ≤ 1.98 GHz clock


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _time_ms(fn, reps: int) -> float:
    """Device time per call of ``reps`` back-to-back calls: the stream is
    held by a sleep kernel while the host queues them, so the host's cost of
    issuing a call (tens of microseconds for a wrapper's checks) does not
    stand in for a short kernel's device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    _check(queued_s < HOLD_CYCLES / 2.5e9, f"queueing {reps} calls took "
           f"{queued_s * 1e3:.1f} ms, longer than the sleep that holds the "
           "stream: lower reps")
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernel parity on the card
# ---------------------------------------------------------------------------

TOLS = {"float32": 2e-5, "float64": 1e-12, "bfloat16": 3e-2}


def _parity(bsk, ops, rng) -> dict:
    """Each kernel vs its plain version on identical inputs; returns the
    worst absolute error per kernel."""
    worst = {"block_spmv": 0.0, "block_spmv_active": 0.0}
    n = 1500
    cases = 0
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        tol = TOLS[str(dt).split(".")[1]]
        for B in (8, 64, 128):
            rows = rng.integers(0, n, 12000)
            cols = rng.integers(0, n, 12000)
            drows = rng.integers(0, n, 400)
            dcols = rng.integers(0, n, 400)
            dvals = np.where(rng.random(400) < 0.5, -1.0, 1.0)
            for padded in (False, True):
                mats = [ops.build_block_sparse(rows, cols, n, n, block=B,
                                               dtype=dt, padded=padded,
                                               device="cuda")]
                if padded:
                    mats.append(ops.apply_delta(
                        ops.build_block_sparse(rows, cols, n, n, block=B,
                                               dtype=dt, padded=True,
                                               device="cuda"),
                        drows, dcols, dvals))
                for mat in mats:
                    x = torch.from_numpy(rng.random(n)).to(dt).cuda()
                    act = torch.from_numpy(rng.random(mat.n_rb) < 0.3)
                    ids = torch.full((mat.n_rb,), -1, dtype=torch.int32)
                    k = int(act.sum())
                    ids[:k] = torch.nonzero(act)[:, 0].to(torch.int32)
                    ids = ids.cuda()
                    act_rows = act.repeat_interleave(B).cuda()
                    for sr in ("sum", "or"):
                        xx = ops._pad_x(mat, x if sr == "sum"
                                        else (x > 0.8).to(dt))
                        kw = dict(block=B, max_tiles=mat.max_tiles,
                                  semiring=sr)
                        args = (mat.tile_idx, mat.tile_cols, mat.tiles, xx)
                        kargs = (mat.tile_idx, mat.tile_cols, mat.index, xx)
                        y = bsk.block_spmv_cuda(*kargs, **kw).double()
                        yp = bsk.block_spmv_plain(*args, **kw).double()
                        err = float((y - yp).abs().max())
                        _check(bool(torch.allclose(y, yp, rtol=tol,
                                                   atol=tol)),
                               f"block_spmv {dt} B={B} padded={padded} "
                               f"{sr}: max abs err {err}")
                        worst["block_spmv"] = max(worst["block_spmv"], err)
                        if sr == "or":
                            _check(bool(((y == 0) | (y == 1)).all()),
                                   "or semiring must give a 0/1 indicator")
                        poisoned = torch.full((mat.n_rb * B,), float("nan"),
                                              dtype=dt, device="cuda")
                        ya = bsk.block_spmv_active_cuda(
                            ids, *kargs, out=poisoned, **kw).double()
                        yap = bsk.block_spmv_active_plain(
                            ids, *args, **kw).double()
                        _check(bool(torch.isnan(ya[~act_rows]).all()),
                               "active kernel wrote a row of an inactive "
                               "block")
                        err = float((ya[act_rows] - yap[act_rows]).abs()
                                    .max()) if k else 0.0
                        _check(bool(torch.allclose(ya[act_rows],
                                                   yap[act_rows], rtol=tol,
                                                   atol=tol)),
                               f"block_spmv_active {dt} B={B} "
                               f"padded={padded} {sr}: max abs err {err}")
                        worst["block_spmv_active"] = max(
                            worst["block_spmv_active"], err)
                        cases += 1
    torch.cuda.synchronize()
    print(f"parity: {cases} cases per kernel passed; worst abs err "
          f"{worst}", flush=True)
    return worst


def _active_rows(ids: np.ndarray, n_rb: int, B: int) -> torch.Tensor:
    live = np.zeros(n_rb, bool)
    live[ids[ids >= 0]] = True
    return torch.from_numpy(np.repeat(live, B)).cuda()


def _packed_cases(bsk, ops, rng) -> dict:
    """Both kernels against their plain versions after every batch of a
    delta stream whose index refresh must compact at least once (f64 and
    f32, B = 64 and 16); two launches bit-identical; a −1 in the middle of
    the active list; a device count ``n_active`` shorter than the list,
    whose later entries must stay unwritten."""
    worst = {"block_spmv": 0.0, "block_spmv_active": 0.0}
    n = 1500
    cases = compactions = refreshes = 0
    for dt, B in ((torch.float64, 64), (torch.float32, 16)):
        tol = TOLS[str(dt).split(".")[1]]
        mat = ops.build_block_sparse(rng.integers(0, n, 12000),
                                     rng.integers(0, n, 12000), n, n,
                                     block=B, dtype=dt, padded=True,
                                     device="cuda")
        for size in (20, 20, 3000, 20, 3000, 20):
            tail0, e_cap0 = mat.index.tail, mat.index.entry_capacity
            mat = ops.apply_delta(mat, rng.integers(0, n, size),
                                  rng.integers(0, n, size),
                                  np.where(rng.random(size) < 0.3, -1.0, 1.0))
            if (mat.index.tail < tail0
                    or mat.index.entry_capacity != e_cap0):
                compactions += 1
            else:
                refreshes += 1
            x = ops._pad_x(mat, torch.from_numpy(rng.random(n)).to(dt)
                           .cuda())
            kw = dict(block=B, max_tiles=mat.max_tiles, semiring="sum")
            args = (mat.tile_idx, mat.tile_cols, mat.tiles, x)
            kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
            y = bsk.block_spmv_cuda(*kargs, **kw)
            _check(bool(torch.equal(y, bsk.block_spmv_cuda(*kargs, **kw))),
                   "two block_spmv launches differ")
            yp = bsk.block_spmv_plain(*args, **kw)
            err = float((y - yp).abs().max())
            _check(bool(torch.allclose(y, yp, rtol=tol, atol=tol)),
                   f"block_spmv after a delta stream: max abs err {err}")
            worst["block_spmv"] = max(worst["block_spmv"], err)
            # a −1 in the middle of the list, then a count that stops the
            # walk before the list's last real entries
            pick = rng.choice(mat.n_rb, 8, replace=False).astype(np.int32)
            ids_h = np.full(mat.n_rb, -1, np.int32)
            ids_h[:3], ids_h[4:9] = pick[:3], pick[3:]
            for count in (None, 6):
                ids = torch.from_numpy(ids_h).cuda()
                n_act = (None if count is None else
                         torch.tensor([count], dtype=torch.int64,
                                      device="cuda"))
                seen = ids_h if count is None else ids_h[:count]
                runs = [bsk.block_spmv_active_cuda(
                    ids, *kargs, n_active=n_act, **kw,
                    out=torch.full((mat.n_rb * B,), float("nan"), dtype=dt,
                                   device="cuda")) for _ in range(2)]
                _check(bool(torch.equal(runs[0].nan_to_num(-7.0),
                                        runs[1].nan_to_num(-7.0))),
                       "two block_spmv_active launches differ")
                ya = runs[0]
                yap = bsk.block_spmv_active_plain(ids, *args, **kw)
                rows = _active_rows(seen, mat.n_rb, B)
                _check(bool(torch.isnan(ya[~rows]).all()),
                       f"active kernel (n_active={count}) wrote a row "
                       "outside its list")
                err = float((ya[rows] - yap[rows]).abs().max())
                _check(bool(torch.allclose(ya[rows], yap[rows], rtol=tol,
                                           atol=tol)),
                       f"block_spmv_active n_active={count}: max abs err "
                       f"{err}")
                worst["block_spmv_active"] = max(
                    worst["block_spmv_active"], err)
            cases += 1
    torch.cuda.synchronize()
    _check(compactions >= 1 and refreshes >= 1,
           f"the delta stream gave {compactions} compactions and "
           f"{refreshes} in-place refreshes; both are needed")
    print(f"packed-index cases: {cases} delta batches ({refreshes} "
          f"refreshes, {compactions} compactions), bit-identical repeats, "
          f"-1 mid-list and a short n_active passed; worst abs err {worst}",
          flush=True)
    return worst


def _poisoned_drive_matches(bsk, pe) -> None:
    """A fused DF drive in which every active-kernel output starts as NaN
    must equal the clean drive bit for bit: no caller reads the rows of
    blocks outside the launch list."""
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road
    hg = grid_road(96, seed=3)
    g = hg.snapshot(block_size=64, device="cuda")
    R0 = torch.full((g.n_pad,), 1.0 / g.n, dtype=torch.float64,
                    device="cuda")
    dels, ins = random_batch(hg, 2e-3, seed=5, deletions_frac=0.2)
    seeds = np.unique(np.concatenate([dels[:, 1], ins[:, 1]]))
    aff = torch.zeros(g.n_pad, dtype=torch.bool, device="cuda")
    aff[torch.as_tensor(seeds, device="cuda")] = True
    clean = pe.run_pallas(g, R0, aff, tau=TAU)

    real = bsk.tile_spmv_active

    def poisoned(active_ids, tile_idx, tile_cols, tiles, x, *, index,
                 **kw):
        out = torch.full((tile_cols.shape[0] * kw["block"],), float("nan"),
                         dtype=x.dtype, device=x.device)
        return bsk.block_spmv_active_cuda(active_ids, tile_idx, tile_cols,
                                          index, x, out=out, **kw)

    bsk.tile_spmv_active = poisoned      # every active launch of the drive
    try:
        dirty = pe.run_pallas(g, R0, aff, tau=TAU)
    finally:
        bsk.tile_spmv_active = real
    _check(not bool(torch.isnan(dirty[0]).any()), "NaN leaked into ranks")
    _check(bool(torch.equal(clean[0], dirty[0])) and clean[1] == dirty[1],
           "poisoned drive differs from the clean drive")
    print(f"poisoned-output drive equals the clean drive "
          f"({clean[1].sweeps} sweeps)", flush=True)


# ---------------------------------------------------------------------------
# phase 4: kernel timing at the main path's shapes
# ---------------------------------------------------------------------------

def _csr(rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int):
    """The pull matrix as a torch.sparse CSR tensor (the yardstick only)."""
    order = np.lexsort((cols, rows))
    r, c = rows[order], cols[order]
    crow = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=crow[1:])
    with warnings.catch_warnings():      # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.as_tensor(crow, device="cuda"),
            torch.as_tensor(c, device="cuda"),
            torch.ones(len(c), dtype=torch.float64, device="cuda"),
            size=(n_rows, n_cols), check_invariants=False)


def _bound(work_bytes: int, flops: int) -> tuple:
    t_bytes, t_ops = work_bytes / HBM_BYTES_PER_S, flops / F64_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _work_bytes(nnz: int, rows: int, live_tiles: int, item: int) -> int:
    """The fewest bytes that hold ``nnz`` nonzeros of ``rows`` rows in
    ``live_tiles`` tiles, over two encodings: CSR (value, 4-byte column
    index, rows + 1 4-byte row pointers) or packed (value, 2-byte in-tile
    place, a 4-byte offset and count per live tile).  x and y are extra."""
    return min(nnz * (item + 4) + (rows + 1) * 4,
               nnz * (item + 2) + live_tiles * 8)


def _active_case(bsk, ops, mat, ids, n_act, x, src, dst, cnt_h,
                 what: str) -> dict:
    """Kernel #2 over the list ``ids`` (its first ``n_act`` entries) with
    operand ``x``: held to its plain version on the listed rows (f64
    tolerance), checked against and timed beside the ``torch.sparse`` CSR
    product of those rows, and its bound: the fewest bytes of the listed
    rows' nonzeros (:func:`_work_bytes`), the x entries they read, y and
    the ids; flops 2 per nonzero."""
    B, mt, n_rb = mat.block, mat.max_tiles, mat.n_rb
    item = mat.tiles.element_size()
    k = int(n_act.item())
    act = ids[:k].long().cpu().numpy()
    kw = dict(block=B, max_tiles=mt, semiring="sum")
    args = (mat.tile_idx, mat.tile_cols, mat.tiles, x)
    kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
    ya = bsk.block_spmv_active_cuda(ids, *kargs, n_active=n_act, **kw)
    yap = bsk.block_spmv_active_plain(ids, *args, **kw)
    rows_act = torch.as_tensor(np.repeat(act, B) * B
                               + np.tile(np.arange(B), k), device="cuda")
    err = float((ya[rows_act] - yap[rows_act]).abs().max())
    _check(bool(torch.allclose(ya[rows_act], yap[rows_act],
                               rtol=TOLS["float64"], atol=TOLS["float64"])),
           f"block_spmv_active ({what}): max abs err {err}")
    live = mat.tile_cols_h >= 0
    tid = mat.tile_idx_h.reshape(n_rb, mt)
    live_a = live[act]
    n_live_a = int(live_a.sum())
    nnz_a = int(cnt_h[tid[act][live_a]].sum())
    in_act = np.isin(dst // B, act)
    n_xa = len(np.unique(src[in_act]))
    n_xcb = len(np.unique(mat.tile_cols_h[act][live_a]))
    work = (_work_bytes(nnz_a, k * B, n_live_a, item) + n_xa * item
            + k * B * item + k * 4)
    layout = (n_live_a * B * B * item + n_rb * 4 + 2 * k * mt * 4
              + n_xcb * B * item + k * B * item)
    pos = np.full(n_rb, -1, np.int64)
    pos[act] = np.arange(k)
    sub_rows = pos[dst[in_act] // B] * B + dst[in_act] % B
    A_sub = _csr(sub_rows, src[in_act], k * B, mat.n_rows)
    xv = x[:mat.n_rows]
    lib = _time_ms(lambda: torch.mv(A_sub, xv), 50)
    _check(bool(torch.allclose(ya[rows_act], torch.mv(A_sub, xv),
                               rtol=1e-12, atol=1e-15)),
           f"block_spmv_active ({what}) disagrees with the CSR product")
    bound, by = _bound(work, 2 * nnz_a)
    return dict(
        name="block_spmv_active", route="cuda",
        source="src/repro_torch/kernels/block_spmv/csrc/block_spmv.cu",
        replaces="src/repro/kernels/block_spmv/block_spmv.py:117",
        max_abs_err=err,
        ms=_time_ms(lambda: bsk.block_spmv_active_cuda(
            ids, *kargs, n_active=n_act, **kw), 200),
        plain_ms=_time_ms(
            lambda: bsk.block_spmv_active_plain(ids, *args, **kw), 3),
        bound_ms=bound, bound_by=by, library_ms=lib,
        work_bytes=work, layout_bytes=layout,
        shape=f"{what}, {n_live_a} live tiles of {B}x{B} f64, {nnz_a} "
        "nonzeros")


def _push_bounds(mat, ids, n_act, x, src, dst, cnt_h) -> str:
    """The push step's own work bounds for one kernel #2 launch of a push
    sweep.  Its operand ``x`` is zero outside the selected source
    column-blocks (and at every vertex it does not push), so the product
    needs less than the candidate rows' every nonzero, which
    :func:`_active_case` counts: (tiles) the nonzeros of the candidate
    rows' live tiles in a selected column-block and the x entries of
    those blocks; (vertices) the out-edges of the pushed vertices (x != 0)
    and their x entries.  Both add y over the candidate rows and the ids;
    flops 2 per nonzero."""
    B, mt, n_rb = mat.block, mat.max_tiles, mat.n_rb
    item = mat.tiles.element_size()
    k = int(n_act.item())
    act = ids[:k].long().cpu().numpy()
    xnz = (x[:mat.n_cols] != 0).cpu().numpy()
    sel_cb = np.zeros(mat.n_cb, bool)
    sel_cb[np.flatnonzero(xnz) // B] = True
    cols_a = mat.tile_cols_h[act]
    in_sel = (cols_a >= 0) & sel_cb[np.maximum(cols_a, 0)]
    tid = mat.tile_idx_h.reshape(n_rb, mt)[act]
    nnz_t, live_t = int(cnt_h[tid[in_sel]].sum()), int(in_sel.sum())
    x_t = int(sel_cb.sum()) * B
    cand = np.zeros(n_rb, bool)
    cand[act] = True
    need = cand[dst // B] & xnz[src]
    nnz_v = int(need.sum())
    live_v = len(np.unique((dst[need] // B) * mat.n_cb + src[need] // B))
    x_v = int(xnz.sum())
    out = k * B * item + k * 4
    lines = []
    for what, nnz, live, xs in (("tiles", nnz_t, live_t, x_t),
                                ("vertices", nnz_v, live_v, x_v)):
        work = _work_bytes(nnz, k * B, live, item) + xs * item + out
        bound, by = _bound(work, 2 * nnz)
        lines.append(f"{what}: {bound:.5f} ms by {by} ({work} work bytes; "
                     f"{nnz} nonzeros in {live} live tiles, {xs} x entries)")
    return (f"push step's own bound ({int(sel_cb.sum())} selected source "
            f"column-blocks, {x_v} pushed vertices): " + "; ".join(lines))


def _print_row(row: dict, smi: str) -> None:
    print(f"{row['name']}: {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}"
          f" ms by {row['bound_by']}: {row['work_bytes']} work bytes; "
          f"layout_bytes {row['layout_bytes']}), plain "
          f"{row['plain_ms']:.3f} ms, torch.sparse "
          f"{row['library_ms']:.4f} ms, max abs err "
          f"{row['max_abs_err']:.3e}, {row['shape']} [{smi}]", flush=True)


def _time_kernels(bsk, ops, sess, rng) -> list:
    """Both kernels at the main path's shapes, held to their plain versions.
    The bound counts the work, whatever layout implements it: the matrix in
    the fewer bytes of two encodings (:func:`_work_bytes`), the x entries
    read once, y written once (plus the id list for #2); flops 2 per
    nonzero.  ``layout_bytes`` is what the dense tiles would move (the
    bound the dense-tile kernels were held to)."""
    mat = sess.inc.mat
    B, mt, n_rb = mat.block, mat.max_tiles, mat.n_rb
    item = mat.tiles.element_size()
    live = mat.tile_cols_h >= 0                       # [n_rb, mt]
    tid = mat.tile_idx_h.reshape(n_rb, mt)
    cnt_h = mat.index.cnt.cpu().numpy().astype(np.int64)
    deg = sess._out_deg.clamp(min=1).to(torch.float64)
    x = ops._pad_x(mat, torch.where(sess.valid, sess.R / deg, 0.0))
    src, dst = sess.hg.snapshot(block_size=B).in_edges_host()
    kw = dict(block=B, max_tiles=mt, semiring="sum")
    args = (mat.tile_idx, mat.tile_cols, mat.tiles, x)
    kargs = (mat.tile_idx, mat.tile_cols, mat.index, x)
    table = []

    # kernel #1: every row-block (the all-active pull of cold/nd/static)
    y = bsk.block_spmv_cuda(*kargs, **kw)
    yp = bsk.block_spmv_plain(*args, **kw)
    err1 = float((y - yp).abs().max())
    _check(bool(torch.allclose(y, yp, rtol=TOLS["float64"],
                               atol=TOLS["float64"])),
           f"block_spmv at n = {sess.n}: max abs err {err1}")
    n_live = int(live.sum())
    nnz = int(cnt_h[tid[live]].sum())
    _check(nnz == len(src), f"index holds {nnz} nonzeros, graph {len(src)}")
    work1 = (_work_bytes(nnz, sess.n_pad, n_live, item) + x.numel() * item
             + n_rb * B * item)
    layout1 = (n_live * B * B * item + 2 * n_rb * mt * 4 + x.numel() * item
               + n_rb * B * item)
    index_read = (nnz * (item + 2) + n_live * 8 + 2 * n_rb * mt * 4
                  + x.numel() * item + n_rb * B * item)
    A = _csr(dst, src, sess.n_pad, sess.n_pad)
    xv = x[:sess.n_pad]
    lib1 = _time_ms(lambda: torch.mv(A, xv), 20)
    yl = torch.mv(A, xv)
    _check(bool(torch.allclose(y[:sess.n_pad], yl, rtol=1e-12, atol=1e-15)),
           "block_spmv disagrees with the CSR product")
    bound1, by1 = _bound(work1, 2 * nnz)
    table.append(dict(
        name="block_spmv", route="cuda",
        source="src/repro_torch/kernels/block_spmv/csrc/block_spmv.cu",
        replaces="src/repro/kernels/block_spmv/block_spmv.py:80",
        max_abs_err=err1,
        ms=_time_ms(lambda: bsk.block_spmv_cuda(*kargs, **kw), 50),
        plain_ms=_time_ms(lambda: bsk.block_spmv_plain(*args, **kw), 3),
        bound_ms=bound1, bound_by=by1, library_ms=lib1,
        work_bytes=work1, layout_bytes=layout1,
        shape=f"all {n_rb} row-blocks, {n_live} live tiles of {B}x{B} f64, "
        f"{nnz} nonzeros"))
    print(f"packed index: {mat.index.nbytes / 1e6:.2f} MB on the card "
          f"(entry capacity {mat.index.entry_capacity}, tail "
          f"{mat.index.tail}); a full launch reads {index_read / 1e6:.2f} MB "
          f"(index, slot tables, x, y) where the dense tiles would move "
          f"{layout1 / 1e6:.2f} MB", flush=True)

    # kernel #2: a 1 % frontier of row-blocks, one launch over the full
    # list stopping at the device count, as the main path calls it
    k = max(1, n_rb // 100)
    act = np.sort(rng.choice(n_rb, size=k, replace=False))
    ids_h = np.full(n_rb, -1, np.int32)
    ids_h[:k] = act
    ids = torch.as_tensor(ids_h, device="cuda")
    n_act = torch.tensor([k], dtype=torch.int64, device="cuda")
    row2 = _active_case(bsk, ops, mat, ids, n_act, x, src, dst, cnt_h,
                        f"{k} of {n_rb} row-blocks (1 %)")
    # the or semiring (the DF frontier expansion) on the same list: a 0/1
    # indicator of ~5 % of the vertices, exact against the plain version
    rows_act = torch.as_tensor(np.repeat(act, B) * B
                               + np.tile(np.arange(B), k), device="cuda")
    x_or = ops._pad_x(mat, torch.as_tensor(rng.random(sess.n_pad) < 0.05,
                                           device="cuda").to(x.dtype))
    kw_or = dict(kw, semiring="or")
    yo = bsk.block_spmv_active_cuda(ids, mat.tile_idx, mat.tile_cols,
                                    mat.index, x_or, n_active=n_act, **kw_or)
    yop = bsk.block_spmv_active_plain(ids, mat.tile_idx, mat.tile_cols,
                                      mat.tiles, x_or, **kw_or)
    _check(bool(torch.equal(yo[rows_act], yop[rows_act])),
           f"block_spmv_active (or) at n = {sess.n} differs from its plain "
           "version")
    _check(bool(((yo[rows_act] == 0) | (yo[rows_act] == 1)).all())
           and bool(yo[rows_act].any()),
           f"or semiring at n = {sess.n} must give a 0/1 indicator with "
           "some ones")
    table.append(row2)
    full_ids = torch.arange(n_rb, dtype=torch.int32, device="cuda")
    n_full = torch.tensor([n_rb], dtype=torch.int64, device="cuda")
    t_full = _time_ms(lambda: bsk.block_spmv_active_cuda(
        full_ids, *kargs, n_active=n_full, **kw), 50)
    t_nocount = _time_ms(lambda: bsk.block_spmv_active_cuda(ids, *kargs,
                                                            **kw), 200)
    print(f"block_spmv_active over the full list: {t_full:.4f} ms (bound "
          f"{_bound(work1 + n_rb * 4, 2 * nnz)[0]:.4f} ms); at the 1 % "
          f"frontier without the device count (walks all {n_rb} entries): "
          f"{t_nocount:.4f} ms; the or semiring at the 1 % frontier equals "
          f"its plain version", flush=True)
    return table


def _time_compaction(bsk, ops, mat, growth: list) -> None:
    """One compaction of the packed index at the main path's size, forced
    the way a stream meets it: a batch's refresh finds the tail full and
    rebuilds the index from the tile pool (a chunked scan of the whole pool
    and one host sync).  The rebuilt index must give the kernel's result bit
    for bit.  ``growth`` is the entries each df update re-packed at the
    tail; their mean says how many updates the tail's room lasts."""
    x = torch.rand(mat.n_cb * mat.block, dtype=mat.tiles.dtype,
                   device="cuda")
    kw = dict(block=mat.block, max_tiles=mat.max_tiles, semiring="sum")
    y = bsk.block_spmv_cuda(mat.tile_idx, mat.tile_cols, mat.index, x, **kw)
    one = np.array([int(mat.tile_idx_h[mat.tile_cols_h.reshape(-1) >= 0][0])])
    times = []
    for _ in range(2):
        full = dataclasses.replace(mat.index, tail=mat.index.entry_capacity,
                                   bound_h=mat.index.bound_h.copy())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = ops.refresh_index(full, mat.tiles, one, np.zeros(1, np.int64),
                                  np.zeros(1, np.int64))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _check(fresh is not full and fresh.tail == int(mat.index.cnt.sum()),
           "the forced refresh did not compact to the live nonzeros")
    _check(bool(torch.equal(y, bsk.block_spmv_cuda(
        mat.tile_idx, mat.tile_cols, fresh, x, **kw))),
        "block_spmv over the compacted index differs")
    per_update = float(np.mean(growth))
    room = fresh.entry_capacity - fresh.tail
    print(f"compaction at n_pad = {mat.n_rows} (tile pool "
          f"{mat.tiles.nbytes / 1e9:.2f} GB, {fresh.tail} entries into a "
          f"capacity of {fresh.entry_capacity}): "
          f"{times[0]:.2f} ms, again {times[1]:.2f} ms; df updates re-pack "
          f"{per_update:.0f} entries each (max {max(growth)}), so after a "
          f"compaction the tail's room of {room} entries lasts about "
          f"{room / per_update:.0f} df updates", flush=True)


def _profile_update(sess, random_batch) -> None:
    """Where one more df update's wall time goes: cProfile's own time per
    function (host work; the waits for the card show up in the driver's
    poll, ``Tensor.cpu``)."""
    driver = sess.config.driver
    import cProfile
    import pstats
    dels, ins = random_batch(sess.hg, 1e-4, seed=999, deletions_frac=0.2)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    res = sess.update(dels, ins)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{Path(fn).name}:{line}({name})", nc)
                   for (fn, line, name), (_, nc, tt, _, _) in stats.items()),
                  reverse=True)[:12]
    print(f"profile of one {driver} df update ({wall * 1e3:.1f} ms wall, "
          f"{res.stats.sweeps} sweeps, {res.host_syncs} host syncs), own "
          "time per function:", flush=True)
    for tt, where, nc in rows:
        print(f"  {tt * 1e3:9.2f} ms {100 * tt / wall:5.1f} %  {nc:6d} calls"
              f"  {where}", flush=True)


def _device_busy(sess, random_batch) -> None:
    """One more df update under ``torch.profiler``: the card's busy time
    (device time of every kernel it ran, one stream, so no overlap) against
    the update's wall time under the profiler."""
    from torch.autograd import DeviceType
    driver = sess.config.driver
    from torch.profiler import ProfilerActivity, profile
    dels, ins = random_batch(sess.hg, 1e-4, seed=1000, deletions_frac=0.2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.update(dels, ins)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms == 0:
        print(f"device busy time of one {driver} df update: not measured (the "
              "profiler recorded no device time)", flush=True)
        return
    print(f"device busy time of one {driver} df update: {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall under the profiler (idle share "
          f"{1 - busy_ms / wall_ms:.3f}); top kernels by device time:",
          flush=True)
    for ms, count, key in kernels[:6]:
        print(f"  {ms:8.3f} ms {count:6d} launches  {key[:90]}", flush=True)


# ---------------------------------------------------------------------------
# phase 6: the push driver on the main path's graph and traffic
# ---------------------------------------------------------------------------

def _push_redrives(bsk, sess, dels, ins) -> tuple:
    """One more df push update whose drive is replayed from the same
    (p, r) state: once clean (must give bit-identical p, r and counters)
    and once with every active-kernel output poisoned to NaN (must equal
    the clean drive bit for bit).  Returns the first push launch's
    operands (ids, count, masked x) of the clean replay."""
    seen = {}
    real_drive = sess._drive_push

    def capture(P0):
        seen["P0"], seen["R0"] = P0.clone(), sess._residual.clone()
        return real_drive(P0)

    sess._drive_push = capture
    try:
        res = sess.update(dels, ins)
    finally:
        del sess._drive_push
    P1, R1 = sess.R, sess._residual
    real_active = bsk.tile_spmv_active
    first = []

    def record(active_ids, tile_idx, tile_cols, tiles, x, **kw):
        if not first:
            first.append((active_ids.clone(), kw["n_active"].clone(),
                          x.clone()))
        return real_active(active_ids, tile_idx, tile_cols, tiles, x, **kw)

    def poisoned(active_ids, tile_idx, tile_cols, tiles, x, *, index,
                 **kw):
        out = torch.full((tile_cols.shape[0] * kw["block"],), float("nan"),
                         dtype=x.dtype, device=x.device)
        return bsk.block_spmv_active_cuda(active_ids, tile_idx, tile_cols,
                                          index, x, out=out, **kw)

    for name, fn in (("repeated", record), ("poisoned-output", poisoned)):
        sess._residual = seen["R0"].clone()
        bsk.tile_spmv_active = fn
        try:
            P2, st2, _, _ = sess._drive_push(seen["P0"])
        finally:
            bsk.tile_spmv_active = real_active
        _check(bool(torch.equal(P2, P1))
               and bool(torch.equal(sess._residual, R1))
               and st2 == res.stats,
               f"the {name} push drive differs from the session's drive")
    sess.R, sess._residual = P1, R1
    print(f"push determinism: a repeated drive and a poisoned-output drive "
          f"from the same (p, r) state equal the session's drive bit for "
          f"bit ({res.stats.sweeps} sweeps)", flush=True)
    return first[0]


def _push_phase(bsk, ops, hg, cfg, batches, pull_df, nd_batch, ref,
                smi: str) -> tuple:
    """The push driver on the same graph and traffic as phase 3; returns
    its launch counts and, for phase 11, its ranks after the df updates and
    after nd, its df walls and the card memory its session held after open
    and warmup.  Also holds and times the kernel #2 launch at the push's
    shapes, and profiles one more push update."""
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.core.push_engine import residual_from_host
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    cold_maxr = float(sess._residual.abs().max())
    cold = (bsk.block_spmv_cuda.launches, bsk.block_spmv_active_cuda.launches)
    print(f"push open + cold solve: {t_open:.2f} s; max|r| {cold_maxr:.3e}; "
          f"launches (block_spmv, block_spmv_active) = {cold}", flush=True)
    _check(cold_maxr <= TAU, f"cold push solve left max|r| = {cold_maxr}")
    sess.warmup()
    mem6 = torch.cuda.memory_allocated() - mem0
    df = []
    for i, ((dels, ins), pull) in enumerate(zip(batches, pull_df)):
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        df.append(res)
        print(f"push df update {i}: {res.wall_time_s * 1e3:.2f} ms "
              f"(pull {pull.wall_time_s * 1e3:.2f}), sweeps "
              f"{res.stats.sweeps} ({pull.stats.sweeps}), pushed blocks "
              f"{res.pushed_blocks}, candidate blocks "
              f"{res.stats.blocks_processed} (pull blocks "
              f"{pull.stats.blocks_processed}), edges "
              f"{res.stats.edges_processed} ({pull.stats.edges_processed}), "
              f"host syncs {res.host_syncs} ({pull.host_syncs}), residual "
              f"mass {res.residual_mass:.3e}, converged {res.converged}",
              flush=True)
        _check(res.host_syncs == 1 + res.stats.sweeps // 8 + 1,
               f"push df update {i} made {res.host_syncs} host syncs; the "
               "floor is one p_src read and one poll per chunk")
    r_df = sess.ranks
    nd = sess.update(*nd_batch, variant="nd")
    torch.cuda.synchronize()
    print(f"push nd update: {nd.wall_time_s * 1e3:.2f} ms, sweeps "
          f"{nd.stats.sweeps}, edges {nd.stats.edges_processed}, host syncs "
          f"{nd.host_syncs}", flush=True)
    top_vals, top_ids = sess.top_k(10)
    q = sess.query(top_ids)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    pwalls = np.array([r.wall_time_s for r in pull_df]) * 1e3
    print(f"push df per-update wall: p50 {np.percentile(walls, 50):.2f} ms, "
          f"p95 {np.percentile(walls, 95):.2f} ms (pull p50 "
          f"{np.percentile(pwalls, 50):.2f}, p95 "
          f"{np.percentile(pwalls, 95):.2f}); edges per update "
          f"{np.mean([r.stats.edges_processed for r in df]):.0f} (pull "
          f"{np.mean([r.stats.edges_processed for r in pull_df]):.0f}); "
          f"launches on the push path: {launches} [{smi}]", flush=True)
    print(f"push report: {sess.report()}", flush=True)
    _check(all(r.converged for r in df) and nd.converged,
           "a push update did not converge")
    _check(sess.report().retraces_post_warmup == 0,
           "a kernel was built after the push session's warmup")
    _check(launches["block_spmv_active"] > 0 and launches["block_spmv"] > 0,
           f"the push path missed a kernel: {launches}")
    _check(bool(np.array_equal(q, top_vals)), "push query != top_k values")

    r = sess.ranks
    err = float(np.abs(r[:sess.n] - ref[:sess.n]).max())
    drift = float(np.abs(sess._residual.cpu().numpy() - residual_from_host(
        sess.hg, sess._out_deg_host, r, cfg.alpha)).max())
    mass = float(r[:sess.n].sum())
    print(f"push oracle: L_inf {err:.3e}, invariant drift "
          f"max|r - residual_from_host| {drift:.3e}, |mass - 1| "
          f"{abs(mass - 1):.3e}", flush=True)
    _check(bool(np.isfinite(r).all()), "push ranks are not finite")
    _check(err <= 1e-8, f"push L_inf vs numpy_reference {err} > 1e-8")
    _check(drift <= 1e-12, f"push residual drift {drift} > 1e-12")
    _check(bool(np.allclose(top_vals, ref[top_ids], rtol=0, atol=1e-8)),
           "push top_k values disagree with the oracle")

    dels, ins = random_batch(sess.hg, 1e-4, seed=2000, deletions_frac=0.2)
    ids, n_act, x = _push_redrives(bsk, sess, dels, ins)
    mat = sess.inc.mat
    src, dst = sess.hg.snapshot(block_size=mat.block).in_edges_host()
    cnt_h = mat.index.cnt.cpu().numpy().astype(np.int64)
    row = _active_case(bsk, ops, mat, ids, n_act, x, src, dst, cnt_h,
                       f"push: first sweep of a df update, {int(n_act.item())}"
                       f" candidate of {mat.n_rb} row-blocks")
    _print_row(row, smi)
    print(f"{_push_bounds(mat, ids, n_act, x, src, dst, cnt_h)} [{smi}]",
          flush=True)
    _profile_update(sess, random_batch)
    _device_busy(sess, random_batch)
    sess.close()
    return launches, {"r_df": r_df, "r_nd": r, "df_ms": walls, "mem": mem6}


# ---------------------------------------------------------------------------
# phase 7: the variant matrix — dt and the replays, snapshot mode, dense
# ---------------------------------------------------------------------------

def _linf_ref(ranks, ref) -> float:
    r = torch.as_tensor(ranks).cpu().numpy()
    n = len(ref)
    return float(np.abs(r[:n] - ref[:n]).max())


def _dt_updates(hg, smi: str):
    """A fresh pull session, ``N_DT_UPDATES`` dt updates, then the df and
    dt replays of the last batch; every result held to the oracle of the
    final graph.  Returns (final host graph, final ranks)."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core import frontier as fr
    from repro_torch.core.delta import random_batch
    from repro_torch.core.pagerank import numpy_reference
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU)
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"variants: pull open + cold solve {time.perf_counter() - t0:.2f}"
          f" s [{smi}]", flush=True)
    sess.warmup()
    last = None
    for i in range(N_DT_UPDATES):
        dels, ins = random_batch(sess.hg, 1e-4, seed=300 + i,
                                 deletions_frac=0.2)
        # the counts below come from the update's own inputs, rebuilt here
        # outside its wall time; the BFS is timed apart
        g_prev = sess.hg.snapshot(block_size=BLOCK)
        last = sess.update(dels, ins, variant="dt")
        torch.cuda.synchronize()
        hops, polls = sess._dt_bfs
        g_cur = sess.hg.snapshot(block_size=BLOCK)
        batch = fr.batch_to_device(g_cur, dels, ins)
        df0 = fr.initial_affected(g_prev, g_cur, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dt0 = fr.dt_affected(g_prev, g_cur, batch)
        torch.cuda.synchronize()
        t_bfs = time.perf_counter() - t0
        _check(bool((dt0 | ~df0).all()), "DT's set misses a DF vertex")
        print(f"dt update {i}: {len(dels)} del + {len(ins)} ins, "
              f"{last.wall_time_s * 1e3:.2f} ms (its two snapshots "
              f"{sess._snap_s * 1e3:.2f} ms, the DT marking alone "
              f"{t_bfs * 1e3:.2f} ms), DT marked "
              f"{int(dt0.sum())} of {sess.n} vertices (DF's initial set "
              f"{int(df0.sum())}), {hops} BFS hops in {polls} polls, host "
              f"syncs {last.host_syncs}, sweeps {last.stats.sweeps}, blocks "
              f"{last.stats.blocks_processed}, edges "
              f"{last.stats.edges_processed}, converged {last.converged} "
              f"[{smi}]", flush=True)
        _check(last.converged, f"dt update {i} did not converge")
    replays = {}
    for variant in ("df", "dt"):
        t0 = time.perf_counter()
        replays[variant] = res = sess.recompute(variant)
        torch.cuda.synchronize()
        print(f"recompute({variant!r}): {(time.perf_counter() - t0) * 1e3:.2f}"
              f" ms (two snapshots {sess._snap_s * 1e3:.2f} ms, solve "
              f"{res.wall_time_s * 1e3:.2f} ms), sweeps "
              f"{res.stats.sweeps}, blocks {res.stats.blocks_processed}, "
              f"edges {res.stats.edges_processed}, converged "
              f"{res.converged} [{smi}]", flush=True)
        _check(res.converged, f"recompute({variant!r}) did not converge")
    _check(bool(torch.equal(replays["dt"].ranks, last.ranks))
           and replays["dt"].stats == last.stats,
           "recompute('dt') differs from the dt update it replays")
    t0 = time.perf_counter()
    ref = numpy_reference(sess.hg.snapshot(block_size=BLOCK))
    errs = {"dt update": _linf_ref(last.ranks, ref),
            "recompute df": _linf_ref(replays["df"].ranks, ref),
            "recompute dt": _linf_ref(replays["dt"].ranks, ref)}
    print(f"variants oracle ({time.perf_counter() - t0:.1f} s): L_inf "
          f"{errs}; the dt replay equals the update bit for bit", flush=True)
    for what, err in errs.items():
        _check(err <= 1e-9, f"{what}: L_inf vs numpy_reference {err} > 1e-9")
    out = sess.hg, sess.ranks
    sess.close()
    return out


def _snapshot_kernels(bsk, ops, mat, g, r_prev, affected) -> None:
    """Both kernels on the snapshot's freshly built pull matrix, held to
    their plain versions (f64 tolerance): #1 over every row-block, #2 (sum
    and or) on the row-blocks of the DF initial frontier.  These launches
    only compare, so the launch counts are put back afterwards."""
    from repro_torch.core import frontier as fr
    from repro_torch.core.graph import contributions, pad_ranks
    counts = (bsk.block_spmv_cuda.launches,
              bsk.block_spmv_active_cuda.launches)
    B, tol = mat.block, TOLS["float64"]
    x = ops._pad_x(mat, contributions(g, pad_ranks(g, r_prev))[:g.n_pad])
    kw = dict(block=B, max_tiles=mat.max_tiles, semiring="sum")
    y = bsk.block_spmv_cuda(mat.tile_idx, mat.tile_cols, mat.index, x, **kw)
    yp = bsk.block_spmv_plain(mat.tile_idx, mat.tile_cols, mat.tiles, x,
                              **kw)
    errs = {"block_spmv": float((y - yp).abs().max())}
    _check(bool(torch.allclose(y, yp, rtol=tol, atol=tol)),
           f"block_spmv on the snapshot matrix: max abs err "
           f"{errs['block_spmv']}")
    act = torch.nonzero(fr.block_any(affected[:g.n_pad] & g.vertex_valid,
                                     g.n_blocks, B))[:, 0]
    k = int(act.numel())
    ids_h = np.full(mat.n_rb, -1, np.int32)
    ids_h[:k] = act.cpu().numpy()
    ids = torch.as_tensor(ids_h, device="cuda")
    n_act = torch.tensor([k], dtype=torch.int64, device="cuda")
    rows = _active_rows(ids_h, mat.n_rb, B)
    x_or = ops._pad_x(mat, affected[:g.n_pad].to(x.dtype))
    for sr, xx in (("sum", x), ("or", x_or)):
        kws = dict(kw, semiring=sr)
        ya = bsk.block_spmv_active_cuda(ids, mat.tile_idx, mat.tile_cols,
                                        mat.index, xx, n_active=n_act,
                                        **kws)
        yap = bsk.block_spmv_active_plain(ids, mat.tile_idx, mat.tile_cols,
                                          mat.tiles, xx, **kws)
        err = float((ya[rows] - yap[rows]).abs().max())
        errs[f"block_spmv_active ({sr})"] = err
        _check(bool(torch.allclose(ya[rows], yap[rows], rtol=tol, atol=tol)),
               f"block_spmv_active ({sr}) on the snapshot matrix: max abs "
               f"err {err}")
    torch.cuda.synchronize()
    bsk.block_spmv_cuda.launches, bsk.block_spmv_active_cuda.launches = counts
    print(f"snapshot matrix: kernel #1 over all {mat.n_rb} row-blocks and #2 "
          f"on the DF frontier's {k} row-blocks match their plain versions; "
          f"max abs err {errs}", flush=True)


def _snapshot_and_dense(bsk, hg, r_prev, smi: str) -> None:
    """Snapshot mode on one more batch: the pull matrix built alone and both
    kernels held to their plain versions on it; a fault-free
    ``df_pagerank`` on that matrix (its drive alone), then one with the
    helping marking (a third of the batch in the first pass) that builds
    its own; then the dense engine's cold BB solve of the same snapshot;
    all held to its oracle."""
    from repro_torch.core import frontier as fr
    from repro_torch.core import pagerank as pr
    from repro_torch.core import pallas_engine as pe
    from repro_torch.core.delta import random_batch
    from repro_torch.core.graph import pull_all
    from repro_torch.kernels.block_spmv import ops
    dels, ins = random_batch(hg, 1e-4, seed=400, deletions_frac=0.2)
    t0 = time.perf_counter()
    g_prev = hg.snapshot(block_size=BLOCK)
    g = hg.apply_batch(dels, ins).snapshot(block_size=BLOCK)
    batch = fr.batch_to_device(g, dels, ins)
    print(f"snapshot mode: two snapshots in {time.perf_counter() - t0:.2f} s"
          f" [{smi}]", flush=True)
    first = np.zeros(batch.shape[0], bool)
    first[::3] = True
    full = fr.initial_affected(g_prev, g, batch)
    helped, checked, rounds = fr.initial_affected_with_helping(
        g_prev, g, batch, first)
    _check(bool(torch.equal(full, helped)) and bool(checked.all())
           and rounds >= 1, "the helping marking differs from the "
           "fault-free one")
    t0 = time.perf_counter()
    mat = pe.build_pull_matrix(g)
    torch.cuda.synchronize()
    print(f"build_pull_matrix alone: {time.perf_counter() - t0:.2f} s, "
          f"{mat.n_tiles()} live tiles ({mat.tiles.nbytes / 1e9:.2f} GB) "
          f"[{smi}]", flush=True)
    _snapshot_kernels(bsk, ops, mat, g, r_prev, full)

    def df_call(what: str, note: str, **kw):
        t0 = time.perf_counter()
        r = pr.df_pagerank(g_prev, g, batch, r_prev, tau=TAU, **kw)
        torch.cuda.synchronize()
        print(f"df_pagerank ({what}): {time.perf_counter() - t0:.2f} s "
              f"(engine run {r.wall_time_s * 1e3:.2f} ms, {note}), sweeps "
              f"{r.stats.sweeps}, blocks {r.stats.blocks_processed}, edges "
              f"{r.stats.edges_processed}, converged {r.converged} [{smi}]",
              flush=True)
        return r

    res = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        # the fault-free call drives on the matrix built above; the helping
        # call builds its own, as a caller without ``pallas_mat`` does
        res["fault-free"] = df_call("fault-free", "the matrix given",
                                    pallas_mat=mat)
        del mat
        torch.cuda.empty_cache()
        res["helping"] = df_call("helping", "its pull-matrix build included",
                                 helping_first_pass=first)
        t0 = time.perf_counter()
        dense = pr.static_pagerank(g, mode="bb", engine="dense", tau=TAU)
        torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    R = dense.ranks
    _check(bool(torch.equal(pull_all(g, R, alpha=0.85),
                            pull_all(g, R, alpha=0.85))),
           "two pull_all calls differ")
    t0 = time.perf_counter()
    ref = pr.numpy_reference(g)
    errs = {k: _linf_ref(v.ranks, ref) for k, v in res.items()}
    errs["dense"] = _linf_ref(R, ref)
    mutual = float((res["helping"].ranks - res["fault-free"].ranks).abs()
                   .max())
    print(f"dense cold solve (BB): {t_dense:.2f} s, {dense.stats.iterations}"
          f" iterations, converged {dense.converged} [{smi}]", flush=True)
    print(f"snapshot oracle ({time.perf_counter() - t0:.1f} s): L_inf {errs};"
          f" helping vs fault-free L_inf {mutual:.3e}, {rounds} helping "
          f"round(s), equal affected sets ({int(full.sum())} vertices)",
          flush=True)
    _check(all(r.converged for r in res.values()) and dense.converged,
           "a snapshot-mode solve did not converge")
    for what, err in errs.items():
        _check(err <= 1e-9, f"{what}: L_inf vs numpy_reference {err} > 1e-9")


def _variants_phase(bsk, hg, smi: str) -> dict:
    """Phase 7; returns its launch counts."""
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    t0 = time.perf_counter()
    hg1, r1 = _dt_updates(hg, smi)
    torch.cuda.empty_cache()
    _snapshot_and_dense(bsk, hg1, r1, smi)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    print(f"launches on the variant path: {launches}; phase 7 took "
          f"{time.perf_counter() - t0:.1f} s [{smi}]", flush=True)
    _check(launches["block_spmv"] > 0 and launches["block_spmv_active"] > 0,
           f"the variant path missed a kernel: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the blocked Gauss–Seidel engine on the main path's graph
# ---------------------------------------------------------------------------

BLOCKED_FAULTS = dict(n_threads=64, n_crashed=48, crash_window=4, seed=3)
# every phase 8 solve's sweeps, blocks, edges and sim_time_ms (6 decimals),
# from the runs of this script on the card before the sweep kernel's
# pipelined redesign; an exact sweep keeps them all
BLOCKED_COUNTERS = {
    "LF cold solve": (27, 442368, 142924932, 1027.660932),
    "session (fault-free) df update 0": (51, 780117, 441303514, 2001.537514),
    "session (fault-free) df update 1": (51, 776297, 438065232, 1990.659232),
    "session (faults=plan) df update 0": (51, 780117, 441303514, 124.592558),
    "session (faults=plan) df update 1": (51, 776297, 438065232, 124.082410),
    "session (thread domain) df update 0": (51, 780117, 441303514,
                                            124.592558),
    "session (thread domain) df update 1": (51, 776297, 438065232,
                                            124.082410),
    "df_pagerank (dense, LF)": (51, 776297, 438065232, 1990.659232),
    "df_pagerank (LF, 48 of 64 threads crashed)": (51, 776297, 438065232,
                                                   124.082410),
    "nd_pagerank (BB, blocked)": (23, 376832, 121762621, 875.426621),
    "df_pagerank (BB, blocked)": (23, 308645, 198741377, 816.031377),
    "nd_pagerank (BB, pallas)": (23, 376832, 121762621, 875.426392),
    "df_pagerank (BB, pallas)": (23, 308645, 198745564, 816.035583),
    "df_pagerank (BB, one crash)": (0, 0, 0, 0.0),
    "paged DF solve": (19, 4314, 2276481, None),
}
CHAIN_BLOCKS = 2048


class _SweepClock:
    """Device time of every sweep launched through the blocked engine's
    dispatcher while installed: CUDA events around each call."""

    def __init__(self, bws):
        self.bws, self.real, self.pairs = bws, bws.blocked_sweep, []

    def __enter__(self):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        self.bws.blocked_sweep = timed
        return self

    def __exit__(self, *exc):
        self.bws.blocked_sweep = self.real

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def _sweep_bound(src_h, ibp_h, ids: np.ndarray, edges: np.ndarray,
                 block: int, item: int) -> tuple:
    """The fewest bytes of one sweep over the listed blocks ``ids`` whose
    per-slot edge counts are ``edges``: each in-edge's source id (4 B), each
    expanded out-edge's two ids (8 B), R and inv_deg read once at every
    distinct source, R and RC written at every listed vertex; 2 flops per
    in-edge.  Returns (bound ms, by, bytes)."""
    lo, hi = ibp_h[ids], ibp_h[ids + 1]
    n_in = int((hi - lo).sum())
    n_out = int(edges.sum()) - n_in
    srcs = len(np.unique(np.concatenate([src_h[a:b]
                                         for a, b in zip(lo, hi)])))
    work = n_in * 4 + n_out * 8 + srcs * 2 * item + len(ids) * block * (
        item + 1)
    bound, by = _bound(work, 2 * n_in)
    return bound, by, work


def _sweep_state(R, aff):
    return R.clone(), aff.clone(), aff.clone()


def _same_counters(what: str, st) -> None:
    """A phase 8 solve's counters against ``BLOCKED_COUNTERS``."""
    sweeps, blocks, edges, sim = BLOCKED_COUNTERS[what]
    got = (st.sweeps, st.blocks_processed, st.edges_processed)
    _check(got == (sweeps, blocks, edges)
           and (sim is None or round(st.sim_time_ms, 6) == sim),
           f"blocked {what}: counters {got}, sim_time_ms {st.sim_time_ms} "
           f"moved from {(sweeps, blocks, edges)}, {sim}")


def _sweep_parity(bws, blk, g, R0, aff0, ids, mask, *, expand: bool,
                  what: str, edges=None) -> dict:
    """One LF and one BB sweep through the kernel and through its plain
    version (both on the card) from the same state: affected, RC and the
    per-slot edges array-equal, R and maxdr within 1e-12.  ``edges`` is a
    pager's view (a paged sweep).  Returns the worst error, the LF
    kernel's per-slot edges and final state, the plain LF sweep's host time
    and the kernel's device time (mean of 3 fresh launches, each
    bit-identical to the first)."""
    sg = blk.sweep_graph(g, R0.dtype, edges)
    kw = dict(n=g.n, alpha=0.85, tau=TAU, tau_f=TAU / 1000.0 if expand
              else float("inf"), tile=512, expand=expand)
    out = {"err": 0.0}
    for mode in ("lf", "bb"):
        jacobi = mode == "bb"
        res = []
        for fn in (bws.blocked_sweep_cuda, bws.blocked_sweep_plain):
            R, A, C = _sweep_state(R0, aff0)
            read = R.clone() if jacobi else R
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, e = fn(sg, R, read, A, C, ids, mask, jacobi=jacobi, **kw)
            torch.cuda.synchronize()
            res.append((R, A, C, m, e, time.perf_counter() - t0))
        (Rk, Ak, Ck, mk, ek, _), (Rp, Ap, Cp, mp, ep, tp) = res
        err = max(float((Rk - Rp).abs().max()), float((mk - mp).abs().max()))
        _check(bool(torch.equal(Ak, Ap)) and bool(torch.equal(Ck, Cp))
               and bool(torch.equal(ek, ep)),
               f"blocked_sweep ({what}, {mode}): affected, RC or per-slot "
               "edges differ from the plain version")
        _check(err <= 1e-12, f"blocked_sweep ({what}, {mode}): max abs err "
               f"{err} > 1e-12")
        out["err"] = max(out["err"], err)
        if mode == "lf":
            out["edges"] = ek.cpu().numpy()
            out["state"] = (Rk, Ak, Ck, mk, ek)
            out["plain_s"] = tp
            times = []
            for _ in range(3):
                R, A, C = _sweep_state(R0, aff0)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                m, e = bws.blocked_sweep_cuda(sg, R, R, A, C, ids, mask,
                                              jacobi=False, **kw)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                _check(all(bool(torch.equal(x, y)) for x, y in zip(
                    (R, A, C, m, e), out["state"])),
                       f"blocked_sweep ({what}): a repeat launch differs "
                       "from the first")
            out["ms"] = float(np.mean(times))
    return out


PAGED_BATCH_EDGES = 16      # benchmarks/scale.py's local insertion batch
PAGED_WINDOW = 4096


class _SetRecorder:
    """A pager that records the active set of each ``ensure`` call and
    stages it through the pager it wraps."""

    def __init__(self, pager):
        self.pager, self.sets = pager, []

    def ensure(self, block_ids):
        self.sets.append(np.asarray(block_ids, np.int64).copy())
        return self.pager.ensure(block_ids)


def _paged_run(bws, blk, hg3, g3, r_cold, smi: str) -> dict:
    """Phase 8's paged run: a DF solve (LF, ``active_policy="rc"``,
    τ_f = τ) of a local insertion batch on phase 3's final graph, first
    unpaged (timed), then through a pager that holds every block, with each
    sweep's active set recorded, then through an ``EdgePager`` whose budget
    holds the largest of those sets and no more — below the snapshot's
    edge bytes — over ``paged_snapshot`` from the same start (timed):
    bit-equal, with misses.  At the default τ_f = τ / 1000 the frontier of
    any batch reaches all 16,384 blocks, and the staging room of every
    block (its longer slice) exceeds the snapshot's edge arrays, so no
    smaller budget could hold it; τ_f = τ stops the expansion where a
    change falls to τ.  Returns what :func:`_paged_sweep_parity` needs."""
    from repro_torch.core import frontier as fr
    from repro_torch.core import tiering
    from repro_torch.core.graph import pad_ranks
    rng = np.random.default_rng(900)
    base = int(rng.integers(0, hg3.n - PAGED_WINDOW))
    ins = base + rng.integers(0, PAGED_WINDOW, (PAGED_BATCH_EDGES, 2))
    dels = np.zeros((0, 2), np.int64)
    gl = hg3.apply_batch(dels, ins).snapshot(block_size=BLOCK, device="cuda")
    aff = fr.initial_affected(g3, gl, fr.batch_to_device(gl, dels, ins))
    R0 = pad_ranks(gl, r_cold)
    ibp = gl.in_block_ptr.cpu().numpy().astype(np.int64)
    obp = gl.out_block_ptr.cpu().numpy().astype(np.int64)
    need = np.maximum(np.diff(ibp), np.diff(obp))   # a block's slab room
    floor = int((np.diff(ibp) + np.diff(obp)).max()) + 1
    kw = dict(mode="lf", tau=TAU, tau_f=TAU, active_policy="rc")
    with _SweepClock(bws) as clock:
        t0 = time.perf_counter()
        R_u, st_u = blk.run_blocked(gl, R0, aff, **kw)
        torch.cuda.synchronize()
        wall_u = time.perf_counter() - t0
    ms_u = clock.ms()
    gp = tiering.paged_snapshot(gl)
    sizer = _SetRecorder(tiering.EdgePager(
        gl, 16 * max(int(need.sum()), floor)))
    R_s, st_s = blk.run_blocked(gp, R0, aff, pager=sizer, **kw)
    _check(bool(torch.equal(R_u, R_s)) and st_u == st_s,
           "the blocked solve through a pager holding every block differs "
           "from the unpaged one")
    sets = sizer.sets
    del sizer, R_s
    largest = max(int(need[a].sum()) for a in sets)
    full = 16 * gl.m_pad                     # src, dst, osrc, odst (int32)
    budget = 16 * max(largest, floor)
    print(f"paged DF solve ({PAGED_BATCH_EDGES} local insertions, LF, rc, "
          f"tau_f = tau): "
          f"active sets {min(len(a) for a in sets)}–"
          f"{max(len(a) for a in sets)} of {gl.n_blocks} blocks over "
          f"{st_u.sweeps} sweeps; the largest needs {largest} slab edges, "
          f"so the budget is {budget} bytes against the snapshot's "
          f"{full} bytes of edges ({budget / full:.3f})", flush=True)
    _check(budget < full, "the paged run's budget is not below the "
           "snapshot's edge bytes")
    pager = tiering.EdgePager(gl, budget)
    with _SweepClock(bws) as clock:
        t0 = time.perf_counter()
        R_p, st_p = blk.run_blocked(gp, R0, aff, pager=pager, **kw)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    ms_p = clock.ms()
    same = bool(torch.equal(R_u, R_p)) and st_u == st_p
    sweeps = max(st_u.sweeps, 1)
    print(f"paged vs unpaged: bit-equal {same}; sweeps {st_p.sweeps}, "
          f"blocks {st_p.blocks_processed}, edges {st_p.edges_processed}; "
          f"wall {wall_p * 1e3:.1f} ms paged against {wall_u * 1e3:.1f} ms "
          f"unpaged; sweep kernel {ms_p / sweeps:.3f} ms a sweep paged "
          f"against {ms_u / sweeps:.3f} ms unpaged; pager {pager.stats()} "
          f"[{smi}]", flush=True)
    _check(same, "the paged blocked solve differs from the unpaged one")
    _same_counters("paged DF solve", st_p)
    _check(st_u.converged, "the paged run's DF solve did not converge")
    _check(pager.counters["misses"] > 0, "the pager missed nothing")
    return {"gl": gl, "gp": gp, "R0": R0, "aff": aff, "first": sets[0],
            "budget": budget, "ibp": ibp}


def _paged_sweep_parity(bws, blk, run: dict, smi: str) -> dict:
    """The paged sweep kernel on the first sweep's active set of
    :func:`_paged_run`, staged alone: against its plain version, and bit
    for bit against the unpaged kernel from the same state.  Returns the
    paged sweep's numbers for the kernel table."""
    from repro_torch.core import tiering
    gl, gp, R0, aff, first = (run[k] for k in ("gl", "gp", "R0", "aff",
                                                "first"))
    K = blk.slot_capacity(len(first), gl.n_blocks)
    ids = torch.full((K,), -1, dtype=torch.int32, device="cuda")
    ids[:len(first)] = torch.as_tensor(first, dtype=torch.int32,
                                       device="cuda")
    mask = torch.arange(K, device="cuda") < len(first)
    aff_x = torch.cat([aff, torch.zeros(1, dtype=torch.bool, device="cuda")])
    view = tiering.EdgePager(gl, run["budget"]).ensure(first)
    par = _sweep_parity(bws, blk, gp, R0, aff_x, ids, mask, expand=True,
                        what=f"paged, {len(first)} of {K} slots", edges=view)
    Rk, Ak, Ck, mk, ek = par["state"]
    R, A, C = _sweep_state(R0, aff_x)
    m, e = bws.blocked_sweep_cuda(
        blk.sweep_graph(gl, R0.dtype), R, R, A, C, ids, mask, n=gl.n,
        alpha=0.85, tau=TAU, tau_f=TAU / 1000.0, tile=512, expand=True,
        jacobi=False)            # as _sweep_parity's LF sweep
    _check(all(bool(torch.equal(a, b)) for a, b in (
        (Rk, R), (Ak, A), (Ck, C), (mk, m), (ek, e))),
           "the paged sweep kernel differs from the unpaged one")
    bound = _sweep_bound(gl.src.cpu().numpy(), run["ibp"], first,
                         par["edges"][:len(first)], BLOCK, 8)
    print(f"blocked_sweep, paged: one sweep of {len(first)} slots "
          f"{par['ms']:.4f} ms on the card (bound {bound[0]:.5f} ms by "
          f"{bound[1]}, {bound[2]} bytes), plain version "
          f"{par['plain_s'] * 1e3:.1f} ms; kernel vs plain max abs err "
          f"{par['err']:.3e}, bit-equal to the unpaged kernel [{smi}]",
          flush=True)
    return {"err": par["err"], "ms": par["ms"], "bound_ms": bound[0]}


def _blocked_phase(bws, bsk, hg3, ref3, smi: str) -> tuple:
    """Phase 8 on phase 3's final graph (``hg3``, whose oracle is ``ref3``).
    Returns (the path's launch counts, the sweep kernel's row)."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core import blocked as blk
    from repro_torch.core import frontier as fr
    from repro_torch.core import pagerank as pr
    from repro_torch.core.delta import random_batch
    from repro_torch.core.fault_domain import ThreadFaultDomain
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.graph import initial_ranks, pad_ranks
    t_phase = time.perf_counter()
    g3 = hg3.snapshot(block_size=BLOCK, device="cuda")
    n_rb, item = g3.n_blocks, 8
    src_h = g3.src.cpu().numpy()
    ibp_h = g3.in_block_ptr.cpu().numpy().astype(np.int64)
    cold_ids = np.arange(n_rb)
    cold_bound = _sweep_bound(src_h, ibp_h, cold_ids,
                              ibp_h[1:] - ibp_h[:-1], BLOCK, item)

    def report(what, res, clock, wall_s):
        st = res.stats
        per = clock.ms() / max(st.sweeps, 1)
        print(f"blocked {what}: {wall_s * 1e3:.2f} ms wall, sweeps "
              f"{st.sweeps}, blocks {st.blocks_processed}, edges "
              f"{st.edges_processed}, sim_time_ms {st.sim_time_ms:.6f}, "
              f"converged {st.converged}, dnf {st.dnf}; sweep kernel "
              f"{clock.ms():.3f} ms ({per:.3f} ms a sweep) [{smi}]",
              flush=True)
        _same_counters(what, st)

    # -- the path: launch counters zeroed just before, read just after -----
    bws.blocked_sweep_cuda.launches = 0
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with _SweepClock(bws) as clock:
            t0 = time.perf_counter()
            cold = pr.static_pagerank(g3, mode="lf", engine="blocked",
                                      tau=TAU)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("LF cold solve", cold, clock, wall)
        err = _linf_ref(cold.ranks, ref3)
        print(f"blocked LF cold solve: L_inf {err:.3e} to phase 3's oracle; "
              f"one sweep's bound {cold_bound[0]:.4f} ms by {cold_bound[1]} "
              f"({cold_bound[2]} bytes) [{smi}]", flush=True)
        _check(cold.converged and err <= 1e-9,
               f"blocked LF cold solve: converged {cold.converged}, L_inf "
               f"{err}")
        _check(cold.stats.blocks_processed == cold.stats.sweeps * n_rb,
               "a cold LF sweep skipped a block")

        # snapshot-mode sessions: fault-free, faults=plan, and the thread
        # domain of the same plan, each taking the same two df batches
        b1 = random_batch(hg3, 1e-4, seed=800, deletions_frac=0.2)
        b2 = random_batch(hg3.apply_batch(*b1), 1e-4, seed=801,
                          deletions_frac=0.2)
        base = dict(engine="blocked", block_size=BLOCK, tau=TAU,
                    dtype=torch.float64)
        cfgs = {"fault-free": EngineConfig(**base),
                "faults=plan": EngineConfig(
                    **base, faults=FaultPlan(**BLOCKED_FAULTS)),
                "thread domain": EngineConfig(**base, fault_domain=(
                    ThreadFaultDomain(FaultPlan(**BLOCKED_FAULTS))))}
        sessions, steps = {}, {}
        for name, cfg in cfgs.items():
            sess = PageRankSession.from_graph(hg3, config=cfg,
                                              r0=cold.ranks, device="cuda")
            _check(not sess._stream, "a blocked session opened in stream "
                   "mode")
            steps[name] = []
            for i, (dels, ins) in enumerate((b1, b2)):
                if name == "fault-free" and i == 1:
                    g4, r_a1 = sess.g, sess.R.clone()
                with _SweepClock(bws) as clock:
                    res = sess.update(dels, ins, variant="df")
                    torch.cuda.synchronize()
                report(f"session ({name}) df update {i}", res, clock,
                       res.wall_time_s)
                steps[name].append(res)
            sessions[name] = sess
        g5 = sessions["fault-free"].g
        t0 = time.perf_counter()
        ref5 = pr.reference_pagerank(g5).cpu().numpy()[:g5.n]
        print(f"oracle of the sessions' final graph (reference_pagerank, "
              f"500 pull steps on the card): {time.perf_counter() - t0:.2f}"
              f" s", flush=True)
        errs = {name: _linf_ref(s.R, ref5) for name, s in sessions.items()}
        same = (bool(torch.equal(sessions["faults=plan"].R,
                                 sessions["thread domain"].R))
                and all(a.stats == b.stats for a, b in zip(
                    steps["faults=plan"], steps["thread domain"])))
        print(f"blocked sessions: L_inf {errs}; thread domain equals "
              f"faults=plan bit for bit: {same}", flush=True)
        _check(same, "fault_domain=ThreadFaultDomain(plan) differs from "
               "faults=plan")
        for name, e in errs.items():
            _check(all(r.converged for r in steps[name]) and e <= 1e-9,
                   f"blocked session ({name}): L_inf {e}")

        # df_pagerank on the second batch, from the fault-free session's
        # ranks after the first
        batch2 = fr.batch_to_device(g5, *b2)
        r_a1 = pad_ranks(g4, r_a1)

        def solve(what, fn, *args, **kw):
            with _SweepClock(bws) as clock:
                t0 = time.perf_counter()
                r = fn(*args, tau=TAU, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(what, r, clock, wall)
            return r

        df_args = (pr.df_pagerank, g4, g5, batch2, r_a1)
        dense = solve("df_pagerank (dense, LF)", *df_args, mode="lf",
                      engine="dense")
        _check(bool(torch.equal(dense.ranks, steps["fault-free"][1].ranks))
               and dense.stats == steps["fault-free"][1].stats,
               "the dense engine's LF mode differs from the blocked "
               "session's update")
        lf_f = solve("df_pagerank (LF, 48 of 64 threads crashed)", *df_args,
                     mode="lf", engine="blocked",
                     faults=FaultPlan(**BLOCKED_FAULTS))
        # BB on both engines: without expansion (nd) they run the same
        # Jacobi recurrence, so every counter must match; with the DF
        # expansion the blocked scan lets a slot update a vertex that an
        # earlier slot of the same sweep marked, and the fused driver does
        # not (the reference's engines differ alike: ROADMAP C 7)
        bb = {}
        for eng in ("blocked", "pallas"):
            bb["nd", eng] = solve(f"nd_pagerank (BB, {eng})", pr.nd_pagerank,
                                  g5, r_a1, mode="bb", engine=eng)
            bb["df", eng] = solve(f"df_pagerank (BB, {eng})", *df_args,
                                  mode="bb", engine=eng)
        bb_c = solve("df_pagerank (BB, one crash)", *df_args, mode="bb",
                     engine="blocked", faults=FaultPlan(
                         n_threads=64, n_crashed=1, crash_window=1, seed=3))
    errs = {"dense LF": _linf_ref(dense.ranks, ref5),
            "LF under faults": _linf_ref(lf_f.ranks, ref5),
            **{f"{v} BB {eng}": _linf_ref(r.ranks, ref5)
               for (v, eng), r in bb.items()}}
    mutual = {v: float((bb[v, "blocked"].ranks - bb[v, "pallas"].ranks)
                       .abs().max()) for v in ("nd", "df")}
    counters = ("sweeps", "blocks_processed", "edges_processed")
    diff = {k: getattr(bb["df", "blocked"].stats, k)
            - getattr(bb["df", "pallas"].stats, k) for k in counters}
    print(f"L_inf to the oracle {errs}; BB blocked vs pallas L_inf "
          f"{mutual}; nd BB counters equal; df BB counters blocked minus "
          f"pallas {diff}; the dense LF solve equals the session's update "
          "bit for bit", flush=True)
    for k in counters:
        _check(getattr(bb["nd", "blocked"].stats, k)
               == getattr(bb["nd", "pallas"].stats, k),
               f"nd BB {k}: blocked {getattr(bb['nd', 'blocked'].stats, k)}"
               f" != pallas {getattr(bb['nd', 'pallas'].stats, k)}")
    for v, e in mutual.items():
        _check(e <= 1e-9, f"{v} BB blocked vs pallas L_inf {e}")
    _check(lf_f.converged and dense.converged
           and all(r.converged for r in bb.values()),
           "a solve on the blocked path did not converge")
    for what, e in errs.items():
        _check(e <= 1e-9, f"{what}: L_inf vs the oracle {e} > 1e-9")
    _check(bb_c.stats.dnf and not bb_c.converged,
           "BB under a crash did not end dnf")
    paged_run = _paged_run(bws, blk, hg3, g3, cold.ranks, smi)
    launches = {"blocked_sweep": bws.blocked_sweep_cuda.launches,
                "block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    _check(launches["blocked_sweep"] > 0, "the blocked path launched no "
           "sweep kernel")

    # -- the kernel against its plain version (launches not counted) --------
    valid_x = torch.cat([g3.vertex_valid,
                         torch.zeros(1, dtype=torch.bool, device="cuda")])
    cold_par = _sweep_parity(
        bws, blk, g3, initial_ranks(g3), valid_x,
        torch.arange(n_rb, dtype=torch.int32, device="cuda"),
        torch.ones(n_rb, dtype=torch.bool, device="cuda"), expand=False,
        what=f"cold start, all {n_rb} slots")
    batch1 = fr.batch_to_device(g4, *b1)
    aff = fr.initial_affected(g3, g4, batch1)
    ids_full, n_act = blk.active_blocks(aff, n_blocks=n_rb,
                                        block_size=BLOCK)
    n_act = int(n_act)
    K = blk.slot_capacity(n_act, n_rb)
    mask = torch.arange(K, device="cuda") < n_act
    df_par = _sweep_parity(
        bws, blk, g4, pad_ranks(g4, cold.ranks),
        torch.cat([aff, torch.zeros(1, dtype=torch.bool, device="cuda")]),
        ids_full[:K].contiguous(), mask, expand=True,
        what=f"DF frontier, {n_act} of {K} slots")
    # a chain of adjacent blocks from the frontier's first: each slot reads
    # the fresh ranks of the slot before it and marks the one after it
    b0 = min(int(ids_full[0]), n_rb - CHAIN_BLOCKS)
    chain = torch.arange(b0, b0 + CHAIN_BLOCKS, dtype=torch.int32,
                         device="cuda")
    chain_par = _sweep_parity(
        bws, blk, g4, pad_ranks(g4, cold.ranks),
        torch.cat([aff, torch.zeros(1, dtype=torch.bool, device="cuda")]),
        chain, torch.ones(CHAIN_BLOCKS, dtype=torch.bool, device="cuda"),
        expand=True, what=f"DF frontier, a chain of {CHAIN_BLOCKS} adjacent "
        f"blocks from block {b0}")
    ibp4 = g4.in_block_ptr.cpu().numpy().astype(np.int64)
    in_only = ibp4[b0 + 1:b0 + CHAIN_BLOCKS + 1] - ibp4[b0:b0 + CHAIN_BLOCKS]
    expanded = int((chain_par["edges"] > in_only).sum())
    print(f"blocked_sweep: DF chain of {CHAIN_BLOCKS} adjacent blocks from "
          f"block {b0}: {chain_par['ms']:.4f} ms on the card, {expanded} "
          f"slots expanded, plain version {chain_par['plain_s'] * 1e3:.1f} "
          f"ms; kernel vs plain max abs err {chain_par['err']:.3e} [{smi}]",
          flush=True)
    _check(expanded > 0, "the chain sweep expanded no slot")
    paged = _paged_sweep_parity(bws, blk, paged_run, smi)
    del paged_run
    df_ids = ids_full[:n_act].cpu().numpy().astype(np.int64)
    df_bound = _sweep_bound(g4.src.cpu().numpy(),
                            g4.in_block_ptr.cpu().numpy().astype(np.int64),
                            df_ids, df_par["edges"][:n_act], BLOCK, item)
    print(f"blocked_sweep: cold sweep of all {n_rb} slots {cold_par['ms']:.3f}"
          f" ms on the card (bound {cold_bound[0]:.4f} ms by "
          f"{cold_bound[1]}, {cold_bound[2]} bytes; "
          f"{cold_par['ms'] * 1e3 / n_rb:.3f} us a slot), plain version "
          f"{cold_par['plain_s'] * 1e3:.1f} ms; DF frontier sweep of {n_act}"
          f" slots {df_par['ms']:.4f} ms (bound {df_bound[0]:.5f} ms by "
          f"{df_bound[1]}, {df_bound[2]} bytes), plain version "
          f"{df_par['plain_s'] * 1e3:.1f} ms; kernel vs plain: LF and BB, "
          f"affected / RC / per-slot edges array-equal, max abs err "
          f"{max(cold_par['err'], df_par['err']):.3e} [{smi}]", flush=True)
    print(f"launches on the blocked path: {launches}; phase 8 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    row = dict(
        name="blocked_sweep", route="cuda",
        source="src/repro_torch/kernels/blocked_sweep/csrc/blocked_sweep.cu",
        replaces="src/repro/core/blocked.py::sweep (lax.scan, no Pallas "
        "kernel)",
        launches=launches["blocked_sweep"],
        max_abs_err=max(cold_par["err"], df_par["err"], chain_par["err"],
                        paged["err"]),
        ms=cold_par["ms"], plain_ms=cold_par["plain_s"] * 1e3,
        bound_ms=cold_bound[0], bound_by=cold_bound[1], library_ms=None)
    return launches, row


# ---------------------------------------------------------------------------
# phase 9: durability on the main path's graph
# ---------------------------------------------------------------------------

STORE_ROOT = ROOT / "build" / "chip_smoke_store"
N_CHILD_UPDATES = 4              # the child is killed after this many
CHILD_CKPT_INTERVAL = 3          # so it dies on checkpoint 3 + 1 WAL batch


def _durable_child(store_dir: str) -> None:
    """``chip_smoke.py --durable-child DIR``: phase 3's session, made
    durable (``checkpoint_interval=3``, store ``DIR``): the same graph, cold
    solve, ``warmup()`` and first four df batches; then it prints READY and
    waits for the parent's SIGKILL."""
    if not torch.cuda.is_available():
        _fail("no CUDA device is visible; the durable child needs one")
    sys.path.insert(0, str(SRC))
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road
    torch.backends.cuda.matmul.allow_tf32 = False
    hg = grid_road(SIDE, seed=7)
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU,
                       durability="wal",
                       checkpoint_interval=CHILD_CKPT_INTERVAL)
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda",
                                      store_dir=store_dir)
    torch.cuda.synchronize()
    print(f"durable open + cold solve + checkpoint 0: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    sess.warmup()
    for i in range(N_CHILD_UPDATES):
        dels, ins = random_batch(sess.hg, 1e-4, seed=100 + i,
                                 deletions_frac=0.2)
        t0 = time.perf_counter()
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        ckpt = (i + 1) % CHILD_CKPT_INTERVAL == 0
        print(f"durable df update {i + 1}: update() {call_ms:.2f} ms"
              f"{' with its checkpoint' if ckpt else ''}, of which the "
              f"step {res.wall_time_s * 1e3:.2f} ms", flush=True)
    print("READY", flush=True)
    time.sleep(900)                      # the parent SIGKILLs it here


def _run_child(store_dir: Path, smi: str) -> None:
    """Start the durable child, echo its lines until READY, SIGKILL it.  A
    child that exits, or does not print READY within 600 s, fails the run
    with the end of its stderr.  A thread reads the child's stdout line by
    line into a queue: ``select`` on the pipe would miss READY whenever it
    arrives in one read with the line before it and so waits in the text
    buffer, not in the pipe."""
    with open(STORE_ROOT / "child-stderr.log", "w+") as err:
        child = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--durable-child",
             str(store_dir)], stdout=subprocess.PIPE, stderr=err, text=True)
        lines: queue.Queue = queue.Queue()

        def pump() -> None:
            for line in child.stdout:
                lines.put(line)
            lines.put(None)                             # EOF

        threading.Thread(target=pump, daemon=True).start()
        try:
            deadline = time.time() + 600
            while True:
                left = deadline - time.time()
                if left <= 0:
                    err.seek(0)
                    raise AssertionError(
                        "the durable child never became READY: "
                        f"{err.read()[-4000:]}")
                try:
                    line = lines.get(timeout=min(left, 5.0))
                except queue.Empty:
                    continue
                if line is None:
                    child.wait(timeout=60)
                    err.seek(0)
                    raise AssertionError(
                        f"the durable child died early (rc "
                        f"{child.returncode}): {err.read()[-4000:]}")
                if line.strip() == "READY":
                    break
                print(f"child: {line.rstrip()} [{smi}]", flush=True)
            os.kill(child.pid, signal.SIGKILL)       # crash-stop, no cleanup
            child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def _durable_phase(bsk, batches, nd_batch, kept: dict, r_nd, df_p50_ms,
                   smi: str) -> dict:
    """Phase 9: a SIGKILLed durable child of phase 3's session restores bit
    for bit and streams on; ``save``/``restore`` of a non-durable session
    and a ``fork`` hold bit for bit too.  ``kept`` holds phase 3's host
    ranks after its 4th and 8th df updates, ``r_nd`` after its nd update.
    Returns the path's launch counts."""
    from repro_torch.api.session import PageRankSession
    t_phase = time.perf_counter()
    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    STORE_ROOT.mkdir(parents=True)
    store_dir = STORE_ROOT / "durable"
    _run_child(store_dir, smi)

    # -- the path: launch counters zeroed just before, read just after -----
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    t0 = time.perf_counter()
    rest = PageRankSession.restore(str(store_dir), device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    replay_active = bsk.block_spmv_active_cuda.launches
    rep = rest.report()
    n = rest.n
    print(f"restore: {t_restore:.3f} s wall, recovery_time_s "
          f"{rep.recovery_time_s:.3f}, replayed_batches "
          f"{rep.replayed_batches} ({rep.recovery_events[0]['description']});"
          f" block_spmv_active launches in the replay {replay_active} "
          f"[{smi}]", flush=True)
    _check(rep.recoveries == 1 and rep.recovery_events[0]["domain"]
           == "process", "restore recorded no process-domain recovery")
    _check(rep.replayed_batches
           == N_CHILD_UPDATES % CHILD_CKPT_INTERVAL,
           f"restore replayed {rep.replayed_batches} batches")
    _check(replay_active > 0, "the WAL replay launched no block_spmv_active")
    _check(bool(np.array_equal(rest.ranks[:n], kept[N_CHILD_UPDATES][:n])),
           "the restored ranks differ from phase 3's after update "
           f"{N_CHILD_UPDATES}")
    calls, walls, wal_ms, wal_bytes = [], [], [], []
    for b, (dels, ins) in enumerate(batches[N_CHILD_UPDATES:],
                                    start=N_CHILD_UPDATES + 1):
        size0 = rest.store.wal_size()
        t0 = time.perf_counter()
        res = rest.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0) * 1e3)
        _check(res.converged, "a durable update did not converge")
        walls.append(res.wall_time_s * 1e3)
        if b % CHILD_CKPT_INTERVAL:      # a checkpoint compacts the WAL
            wal_ms.append(calls[-1] - walls[-1])
            wal_bytes.append(rest.store.wal_size() - size0)
    _check(bool(np.array_equal(rest.ranks[:n], kept[N_DF_UPDATES][:n])),
           "the restored stream differs from phase 3's after update "
           f"{N_DF_UPDATES}")
    _check(rest.report().retraces_post_warmup == 0,
           "a kernel was built after the restore")
    print(f"durable df updates {N_CHILD_UPDATES + 1}-{N_DF_UPDATES} after "
          f"the restore (one with its checkpoint): update() "
          f"{', '.join(f'{w:.2f}' for w in calls)} ms, p50 "
          f"{np.percentile(calls, 50):.2f} ms (WAL and checkpoint "
          f"included); the step alone p50 {np.percentile(walls, 50):.2f} ms"
          f" beside phase 3's df p50 {df_p50_ms:.2f} ms; bit-identical to "
          f"phase 3 after updates {N_CHILD_UPDATES} and {N_DF_UPDATES} "
          f"[{smi}]", flush=True)
    print(f"WAL per record (update() minus its step: validation, append "
          f"and fsync; the batches without a checkpoint): {', '.join(f'{w:.3f}' for w in wal_ms)} ms, p50 "
          f"{np.percentile(wal_ms, 50):.3f} ms; records of "
          f"{min(wal_bytes)}-{max(wal_bytes)} bytes [{smi}]", flush=True)
    t0 = time.perf_counter()
    path = rest.save()
    t_ckpt = time.perf_counter() - t0
    print(f"checkpoint (save into the attached store): {_dir_bytes(path)} "
          f"bytes in {t_ckpt:.3f} s [{smi}]", flush=True)

    # -- fork: the parent stays, the branch equals phase 3 on the same batch
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    twin = rest.fork()
    torch.cuda.synchronize()
    fork_ms = (time.perf_counter() - t0) * 1e3
    fork_bytes = torch.cuda.memory_allocated() - mem0
    _check(twin.store is None, "the fork kept the parent's store")
    twin.update(*nd_batch, variant="nd")
    torch.cuda.synchronize()
    _check(bool(np.array_equal(rest.ranks[:n], kept[N_DF_UPDATES][:n])),
           "the fork's update changed the parent")
    _check(bool(np.array_equal(twin.ranks[:n], r_nd[:n])),
           "the fork's nd update differs from phase 3's")
    rest.update(*nd_batch, variant="nd")
    _check(bool(np.array_equal(rest.ranks[:n], twin.ranks[:n])),
           "the parent given the fork's batch differs from the fork")
    print(f"fork: {fork_ms:.2f} ms, +{fork_bytes / 1e9:.3f} GB of device "
          f"memory; after the same nd batch fork == parent == phase 3 bit "
          f"for bit [{smi}]", flush=True)
    plain_cfg = rest.config.replace(durability="none")
    rest.close()
    twin.close()
    del twin, rest
    torch.cuda.empty_cache()

    # -- save/restore of a non-durable session -----------------------------
    # the store reopened without durability (the parent's nd update was
    # batch 9, a checkpoint of the cadence)
    plain = PageRankSession.restore(str(store_dir), config=plain_cfg,
                                    device="cuda")
    _check(plain.store is None and plain._batch_index == N_DF_UPDATES + 1,
           "the non-durable reopen attached a store or lost a batch")
    _check(bool(np.array_equal(plain.ranks[:n], r_nd[:n])),
           "the reopened store differs from phase 3's nd update")
    saved = str(STORE_ROOT / "saved")
    t0 = time.perf_counter()
    plain.save(saved)
    t_save = time.perf_counter() - t0
    plain.close()
    del plain
    torch.cuda.empty_cache()
    back = PageRankSession.restore(saved, device="cuda")
    torch.cuda.synchronize()
    _check(back.config.durability == "none" and back.store is None,
           "the restored save is durable")
    _check(bool(np.array_equal(back.ranks[:n], r_nd[:n])),
           "save/restore of a non-durable session is not bit-identical")
    print(f"save of a non-durable session: {_dir_bytes(saved)} bytes in "
          f"{t_save:.3f} s; its restore "
          f"{back.report().recovery_time_s:.3f} s, bit-identical [{smi}]",
          flush=True)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": 0}
    back.close()
    torch.cuda.empty_cache()
    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    print(f"launches on the durable path: {launches}; phase 9 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 10: the tiered pull path on the main path's graph
# ---------------------------------------------------------------------------

def _linf(a: np.ndarray, b: np.ndarray, n: int) -> float:
    return float(np.abs(a[:n] - b[:n]).max())


def _tiered_phase(bsk, hg, batches, nd_batch, p3: dict, smi: str) -> dict:
    """Phase 10: tiered pull sessions (``device_budget_bytes``) on phase 3's
    graph and batches.  ``p3`` holds phase 3's numbers: its opening ranks
    (``r_open``), its ranks after the 8 df updates (``r_df``) and after the
    nd update (``r_nd``), the oracle of its final graph (``ref``), the
    card memory its session held (``mem``), its df walls (``df_ms``) and
    host syncs (``syncs``).  A half-budget session opens with a tiered
    cold solve (it must evict and refill), streams the batches and is held
    to phase 3 and its oracle; a full-budget one warm-starts from phase
    3's opening ranks; the half-budget one is saved, restored untiered and
    under the full budget (bit for bit) and forked.  Returns the path's
    launch counts, the host pool's bytes and the half-budget session's df
    walls (ms)."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession, SweepCapWarning
    from repro_torch.core import tiering
    from repro_torch.core.delta import random_batch
    t_phase = time.perf_counter()
    n = hg.n
    g0 = hg.snapshot(block_size=BLOCK, device="cpu")
    src, dst = g0.in_edges_host()
    t0 = time.perf_counter()
    pool = tiering.HostTilePool.from_edges(dst, src, g0.n_pad, g0.n_pad,
                                           block=BLOCK, dtype=np.float64)
    t_pool = time.perf_counter() - t0
    pool_bytes = pool.nbytes
    live = int((pool.tile_cols >= 0).sum())
    del pool, g0, src, dst
    half = pool_bytes // 2
    cap = tiering.slab_tiles_for_budget(half, BLOCK, np.float64)
    print(f"host pool: {pool_bytes} bytes ({pool_bytes / 1e9:.2f} GB, "
          f"{live} live tiles) built in {t_pool:.2f} s; half budget "
          f"{half} bytes = {cap} slab slots ({cap - 1} usable) [{smi}]",
          flush=True)
    _check(cap - 1 < live, "the half budget holds every live tile")
    # the refill loop's cap is max_iterations rounds; a tiered cold solve at
    # this size needs over a thousand (the deferral window walks the grid) —
    # a drive that converges is the same under either cap
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU,
                       device_budget_bytes=half,
                       max_iterations=TIERED_MAX_ITERATIONS)

    # -- the path: launch counters zeroed just before, read just after -----
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        t0 = time.perf_counter()
        sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
        torch.cuda.synchronize()
        t_open = time.perf_counter() - t0
        tier_open = dict(sess.hot.stats())
        cold = bsk.block_spmv_active_cuda.launches
        print(f"tiered open + cold solve (half budget): {t_open:.2f} s, "
              f"refill rounds {tier_open['refill_drives']}, evictions "
              f"{tier_open['evictions']}, admitted tiles "
              f"{tier_open['admitted_tiles']}, slab repacks "
              f"{tier_open['index_repacks']}; block_spmv_active launches "
              f"{cold} [{smi}]", flush=True)
        sess.warmup()
        mem_tiered = torch.cuda.memory_allocated() - mem0
        admit_ms: List[float] = []
        orig_admit = sess.hot.admit

        def timed_admit(want_rb):
            t = time.perf_counter()
            out = orig_admit(want_rb)
            admit_ms[-1] += (time.perf_counter() - t) * 1e3
            return out

        sess.hot.admit = timed_admit
        df = []
        for i, (dels, ins) in enumerate(batches):
            admit_ms.append(0.0)
            c0 = dict(sess.hot.counters)
            res = sess.update(dels, ins, variant="df")
            torch.cuda.synchronize()
            df.append(res)
            c1 = sess.hot.counters
            print(f"tiered df update {i}: {res.wall_time_s * 1e3:.2f} ms "
                  f"(admission {admit_ms[-1]:.2f} ms host), sweeps "
                  f"{res.stats.sweeps}, edges {res.stats.edges_processed}, "
                  f"host syncs {res.host_syncs}, refill rounds "
                  f"{c1['refill_drives'] - c0['refill_drives']}, evictions "
                  f"{c1['evictions'] - c0['evictions']}, admitted tiles "
                  f"{c1['admitted_tiles'] - c0['admitted_tiles']}, "
                  f"converged {res.converged}", flush=True)
        r_df = sess.ranks
        admit_ms.append(0.0)
        nd = sess.update(*nd_batch, variant="nd")
        torch.cuda.synchronize()
        del sess.hot.admit              # a fork copies the instance's dict
    df_launches = bsk.block_spmv_active_cuda.launches - cold
    rep = sess.report()
    t = rep.tiering
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    print(f"tiered nd update: {nd.wall_time_s * 1e3:.2f} ms (admission "
          f"{admit_ms[-1]:.2f} ms host), sweeps {nd.stats.sweeps}, host "
          f"syncs {nd.host_syncs}", flush=True)
    print(f"tiered df p50 {np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms beside phase 3's p50 "
          f"{np.percentile(p3['df_ms'], 50):.2f} ms, p95 "
          f"{np.percentile(p3['df_ms'], 95):.2f} ms; host syncs per update "
          f"{[r.host_syncs for r in df]} beside phase 3's {p3['syncs']}; "
          f"admission per df update p50 "
          f"{np.percentile(admit_ms[:len(df)], 50):.2f} ms host "
          f"[{smi}]", flush=True)
    print(f"card memory: tiered session {mem_tiered} bytes "
          f"({mem_tiered / 1e9:.3f} GB) beside phase 3's untiered "
          f"{p3['mem']} bytes ({p3['mem'] / 1e9:.3f} GB) "
          f"(torch.cuda.memory_allocated after open + warmup) [{smi}]",
          flush=True)
    print(f"tiered report().device_bytes: {rep.device_bytes}", flush=True)
    print(f"tiered report().tiering: {t}", flush=True)
    print(f"launches after the cold solve (warmup, 8 df, nd): "
          f"block_spmv_active {df_launches}, block_spmv "
          f"{bsk.block_spmv_cuda.launches}", flush=True)
    _check(all(r.converged for r in df) and nd.converged,
           "a tiered update did not converge")
    _check(t["evictions"] > 0 and t["refill_drives"] > 0,
           "the half-budget session neither evicted nor refilled")
    _check(rep.device_bytes["tile_pool"] == 0,
           "the tiered session holds dense tiles on the card")
    e_df = _linf(r_df, p3["r_df"], n)
    r_nd = sess.ranks
    e_nd = _linf(r_nd, p3["r_nd"], n)
    e_ref = _linf(r_nd, p3["ref"], n)
    print(f"tiered L_inf: after the df updates {e_df:.3e} to phase 3's; "
          f"after nd {e_nd:.3e} to phase 3's and {e_ref:.3e} to its "
          f"oracle", flush=True)
    _check(max(e_df, e_nd, e_ref) <= 1e-8,
           f"tiered ranks off phase 3 or its oracle: {e_df}, {e_nd}, "
           f"{e_ref}")

    # -- save, restore untiered and under the full budget, fork ------------
    store = STORE_ROOT / "tiered"
    shutil.rmtree(store, ignore_errors=True)
    sess.save(str(store))
    for what, budget in (("untiered", None), ("full budget", pool_bytes)):
        t0 = time.perf_counter()
        back = PageRankSession.restore(
            str(store), config=cfg.replace(device_budget_bytes=budget),
            device="cuda")
        torch.cuda.synchronize()
        _check(bool(np.array_equal(back.ranks[:n], r_nd[:n])),
               f"the {what} restore of the tiered save is not bit-equal")
        print(f"restore of the half-budget save, {what}: "
              f"{time.perf_counter() - t0:.2f} s, bit-equal", flush=True)
        back.close()
        del back
        torch.cuda.empty_cache()
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    child = sess.fork()
    fork_s = time.perf_counter() - t0
    dels, ins = random_batch(sess.hg, 1e-4, seed=100 + N_DF_UPDATES + 1,
                             deletions_frac=0.2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        _check(sess.update(dels, ins, variant="df").converged,
               "the parent's update after the fork did not converge")
    _check(bool(np.array_equal(child.ranks[:n], r_nd[:n])),
           "the parent's update moved the fork's ranks")
    print(f"fork of the half-budget session: {fork_s:.2f} s; the parent "
          f"took one more batch, the child's ranks did not move", flush=True)
    child.close()
    del child
    torch.cuda.empty_cache()

    # -- the full budget, warm-started from phase 3's opening ranks --------
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        t0 = time.perf_counter()
        full = PageRankSession.from_graph(
            hg, config=cfg.replace(device_budget_bytes=pool_bytes),
            r0=p3["r_open"], device="cuda")
        full.warmup()
        t_open = time.perf_counter() - t0
        fres = [full.update(d, i, variant="df") for d, i in batches]
        torch.cuda.synchronize()
    ft = full.report().tiering
    e_full = _linf(full.ranks, p3["r_df"], n)
    fwalls = np.array([r.wall_time_s for r in fres]) * 1e3
    print(f"tiered full budget (warm start): open {t_open:.2f} s; df p50 "
          f"{np.percentile(fwalls, 50):.2f} ms, p95 "
          f"{np.percentile(fwalls, 95):.2f} ms; evictions "
          f"{ft['evictions']}, refill rounds {ft['refill_drives']}; "
          f"L_inf {e_full:.3e} to phase 3's df ranks [{smi}]", flush=True)
    _check(all(r.converged for r in fres), "a full-budget update did not "
           "converge")
    _check(e_full <= 1e-8, f"full-budget ranks off phase 3: {e_full}")
    full.close()
    sess.close()
    del full, sess
    torch.cuda.empty_cache()
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": 0}
    print(f"launches on the tiered path: {launches}; phase 10 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    return launches, pool_bytes, walls


# ---------------------------------------------------------------------------
# phase 11: the tiered push path on the main path's graph
# ---------------------------------------------------------------------------

def _tiered_push_phase(bsk, hg, batches, nd_batch, budget: int, p3: dict,
                       p6: dict, smi: str) -> dict:
    """Phase 11: a push session under ``device_budget_bytes=budget`` (half
    the host pool) on phase 3's graph and batches, warm-started from phase
    3's opening ranks (its residual rebuilt from host truth, so no cold
    solve), with the launch counters zeroed just before and read at the
    end.  Every update must converge with no ``SweepCapWarning``, the
    ranks stay within 1e-8 of phase 6's push ranks and of phase 3's
    oracle, and the residual within 1e-12 of host truth after the last
    batch.  ``p3``/``p6`` hold phases 3's and 6's numbers.  Returns the
    path's launch counts."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession, SweepCapWarning
    from repro_torch.core.push_engine import residual_from_host
    t_phase = time.perf_counter()
    n = hg.n
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU,
                       driver="push", device_budget_bytes=budget,
                       max_iterations=TIERED_MAX_ITERATIONS)

    # -- the path: launch counters zeroed just before, read just after -----
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        t0 = time.perf_counter()
        sess = PageRankSession.from_graph(hg, config=cfg, r0=p3["r_open"],
                                          device="cuda")
        torch.cuda.synchronize()
        t_open = time.perf_counter() - t0
        maxr = float(sess._residual.abs().max())
        sess.warmup()
        mem = torch.cuda.memory_allocated() - mem0
        print(f"tiered push open (warm start, residual from host truth): "
              f"{t_open:.2f} s, max|r| {maxr:.3e}; warmup refill rounds "
              f"{sess.hot.counters['refill_drives']} [{smi}]", flush=True)
        df, rounds = [], []
        for i, (dels, ins) in enumerate(batches):
            c0 = dict(sess.hot.counters)
            res = sess.update(dels, ins, variant="df")
            torch.cuda.synchronize()
            df.append(res)
            c1 = sess.hot.counters
            rounds.append(c1["refill_drives"] - c0["refill_drives"])
            print(f"tiered push df update {i}: {res.wall_time_s * 1e3:.2f} "
                  f"ms, sweeps {res.stats.sweeps}, pushed blocks "
                  f"{res.pushed_blocks}, edges {res.stats.edges_processed}, "
                  f"host syncs {res.host_syncs}, refill rounds {rounds[-1]},"
                  f" evictions {c1['evictions'] - c0['evictions']}, admitted"
                  f" tiles {c1['admitted_tiles'] - c0['admitted_tiles']}, "
                  f"converged {res.converged}", flush=True)
        r_df = sess.ranks
        c0 = dict(sess.hot.counters)
        nd = sess.update(*nd_batch, variant="nd")
        torch.cuda.synchronize()
    print(f"tiered push nd update: {nd.wall_time_s * 1e3:.2f} ms, sweeps "
          f"{nd.stats.sweeps}, host syncs {nd.host_syncs}, refill rounds "
          f"{sess.hot.counters['refill_drives'] - c0['refill_drives']}",
          flush=True)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": 0}
    rep = sess.report()
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    print(f"tiered push df p50 {np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms beside phase 6's p50 "
          f"{np.percentile(p6['df_ms'], 50):.2f} ms, p95 "
          f"{np.percentile(p6['df_ms'], 95):.2f} ms; refill rounds per "
          f"update {rounds}; host syncs per update "
          f"{[r.host_syncs for r in df]} [{smi}]", flush=True)
    print(f"card memory: tiered push session {mem} bytes "
          f"({mem / 1e9:.3f} GB) beside phase 6's untiered push "
          f"{p6['mem']} bytes ({p6['mem'] / 1e9:.3f} GB) "
          f"(torch.cuda.memory_allocated after open + warmup) [{smi}]",
          flush=True)
    print(f"tiered push report().device_bytes: {rep.device_bytes}",
          flush=True)
    print(f"tiered push report().tiering: {rep.tiering}", flush=True)
    r_nd = sess.ranks
    e_df = _linf(r_df, p6["r_df"], n)
    e_nd = _linf(r_nd, p6["r_nd"], n)
    e_ref = _linf(r_nd, p3["ref"], n)
    drift = float(np.abs(sess._residual.cpu().numpy() - residual_from_host(
        sess.hg, sess._out_deg_host, r_nd, cfg.alpha)).max())
    print(f"tiered push L_inf: after the df updates {e_df:.3e} to phase 6's;"
          f" after nd {e_nd:.3e} to phase 6's and {e_ref:.3e} to phase 3's "
          f"oracle; residual drift to host truth {drift:.3e}; launches on "
          f"the tiered push path: {launches}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    _check(all(r.converged for r in df) and nd.converged,
           "a tiered push update did not converge")
    _check(rep.tiering["refill_drives"] > 0 and rep.tiering["misses"] > 0,
           "the tiered push session never deferred a block")
    _check(rep.device_bytes["tile_pool"] == 0,
           "the tiered push session holds dense tiles on the card")
    _check(max(e_df, e_nd, e_ref) <= 1e-8,
           f"tiered push ranks off phase 6 or phase 3's oracle: {e_df}, "
           f"{e_nd}, {e_ref}")
    _check(drift <= 1e-12, f"tiered push residual drift {drift} > 1e-12")
    _check(launches["block_spmv_active"] > 0,
           "the tiered push path launched no block_spmv_active")
    sess.close()
    del sess
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: integrity and the repair ladder on the main path's graph
# ---------------------------------------------------------------------------

# each kind, the check that must find it and the rung that must heal it
# (tests/test_integrity.py); the scatter kinds tear the update after them
KIND_CHECK_RUNG = (("rank", "rank_drift", "frontier"),
                   ("tile", "tile_sums", "rebuild"),
                   ("slot", "slot_tables", "rebuild"),
                   ("mirror", "mirror_digest", "rebuild"),
                   ("scatter_drop", "mirror_digest", "rebuild"),
                   ("scatter_dup", "mirror_digest", "rebuild"),
                   ("graph", "graph_digest", "restore"))


def _ms(seconds: dict) -> dict:
    return {k: round(v * 1e3, 2) for k, v in seconds.items()}


def _integrity_phase(bsk, hg, batches, nd_batch, p3: dict, budget: int,
                     tier_ms, smi: str) -> dict:
    """Phase 12: the corruption domain at n = 1M, after phase 11.  A durable
    session with ``integrity=`` streams phase 3's batches (the same host
    syncs, ranks within 1e-8 of phase 3's); a clean deep ``verify()`` is
    timed, split by the session's own part timings; each corruption kind
    is injected and must be found by its check, healed at its rung (kernel
    #2 launched in every repair drive) and end clean within 1e-8 of phase
    3's ranks; a deferred ``tile`` meets the fused gate of an
    auto-repairing session.  Then a tiered session with ``integrity=`` at
    phase 10's half budget (``budget``), warm-started from phase 3's
    opening ranks, streams phase 3's first batches under the fused gate
    (no alert, ranks within 1e-8 of phase 3's; ``df`` p50 beside phase
    10's ``tier_ms``), verifies clean and repairs a ``rank`` flip at
    ``frontier``.  Returns the phase's launch counts."""
    from repro_torch.api import EngineConfig, IntegrityConfig, PageRankSession
    from repro_torch.api.session import SweepCapWarning
    from repro_torch.core.delta import random_batch
    from repro_torch.core.incremental import effective_batch
    t_phase = time.perf_counter()
    n = hg.n
    # a converged pull iterate leaves |sum - 1| up to n * tau, above the
    # default mass_tol (calibrated for n <= ~1e4)
    mass_tol = n * TAU
    print(f"integrity: mass_tol = n * tau = {mass_tol:.6e} (default "
          f"{IntegrityConfig().mass_tol:g})", flush=True)
    icfg = IntegrityConfig(mass_tol=mass_tol, auto_repair=False)
    store = STORE_ROOT / "integrity"
    shutil.rmtree(store, ignore_errors=True)
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU,
                       integrity=icfg, durability="wal")

    def linf_to(ranks, ref):
        return _linf(ranks, ref, n)

    def active():
        return bsk.block_spmv_active_cuda.launches

    # -- the path: launch counters zeroed just before, read at the end -----
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda",
                                      store_dir=str(store))
    torch.cuda.synchronize()
    print(f"integrity session open (durable, cold solve): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sess.warmup()
    df = []
    for dels, ins in batches:
        df.append(sess.update(dels, ins, variant="df"))
        torch.cuda.synchronize()
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    syncs = [r.host_syncs for r in df]
    e_df = linf_to(sess.ranks, p3["r_df"])
    print(f"integrity df p50 {np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms beside phase 3's p50 "
          f"{np.percentile(p3['df_ms'], 50):.2f} ms (durable + integrity=);"
          f" host syncs {syncs} beside phase 3's {p3['syncs']}; L_inf "
          f"{e_df:.3e} to phase 3's df ranks; fused alert "
          f"{sess._integrity_alert} [{smi}]", flush=True)
    _check(all(r.converged for r in df), "an integrity df update did not "
           "converge")
    _check(syncs == p3["syncs"], f"integrity= changed the host syncs: "
           f"{syncs} against {p3['syncs']}")
    _check(e_df <= 1e-8, f"integrity df ranks off phase 3: {e_df}")

    # -- a clean deep verify, timed and split ------------------------------
    torch.cuda.synchronize()
    rep = sess.verify(repair=False, deep=True)
    print(f"clean verify(deep): checks_run {rep.checks_run}, wall_time_s "
          f"{rep.wall_time_s:.4f}, mass_error {rep.mass_error:.3e}; its "
          f"parts (ms): {_ms(rep.split_s)} [{smi}]", flush=True)
    _check(rep.ok and not rep.failures, f"clean verify failed: "
           f"{rep.failures}")

    # -- every kind: detected by its check, healed at its rung -------------
    dels_e, ins_e = effective_batch(sess.hg, *nd_batch)
    inverse = (ins_e, dels_e)       # takes phase 3's nd batch back out
    # a rung's RecoveryRecord spans the rung and the re-check after it (the
    # reference's accounting); the report's rung_s times the rung alone
    for seed, (kind, check, rung) in enumerate(KIND_CHECK_RUNG):
        sess.inject_corruption(kind, seed=seed)
        want = p3["r_df"]
        if kind == "scatter_drop":
            sess.update(*nd_batch, variant="nd")     # the torn update
            want = p3["r_nd"]
        elif kind == "scatter_dup":
            sess.update(*inverse, variant="df")
        torch.cuda.synchronize()
        a0 = active()
        rep = sess.verify(repair=True, deep=True)
        torch.cuda.synchronize()
        rec = sess._recoveries[-1] if sess._recoveries else None
        after = sess.verify(repair=False, deep=True)
        err = linf_to(sess.ranks, want)
        found = [f["check"] for f in rep.failures]
        print(f"integrity {kind}: found by {found}, repairs {rep.repairs}, "
              f"verify {rep.wall_time_s:.3f} s (detection "
              f"{sum(rep.split_s.values()):.3f} s), rung {rung} "
              f"{rep.rung_s.get(rung, float('nan')):.3f} s alone, "
              f"{rec.wall_time_s if rec else float('nan'):.3f} s with its "
              f"re-check (its RecoveryRecord), block_spmv_active launches "
              f"{active() - a0}, then clean {after.ok}, L_inf {err:.3e} to "
              f"phase 3's [{smi}]", flush=True)
        _check(check in found, f"{kind} was not found by {check}: {found}")
        _check(rep.ok and rep.repairs == [rung],
               f"{kind} was not healed at {rung}: {rep.repairs}")
        _check(rec is not None and rec.rung == rung
               and rec.domain == "corruption", f"{kind}: no {rung} record")
        _check(active() > a0, f"the {rung} repair of {kind} launched no "
               "block_spmv_active")
        _check(after.ok and not after.failures,
               f"{kind}: not clean after the repair: {after.failures}")
        _check(err <= 1e-8, f"{kind}: ranks off phase 3 after the repair: "
               f"{err}")
    integ = sess.report().integrity
    print(f"integrity report: {integ}", flush=True)
    _check(integ["corruption_detected"] == len(KIND_CHECK_RUNG),
           f"corruption_detected {integ['corruption_detected']}")
    hg_df, r_df = sess.hg, sess.R.clone()
    # where an integrity= df update's time goes (one more batch; the
    # session closes after it)
    print("integrity= and durable, one more df update:", flush=True)
    _profile_update(sess, random_batch)
    sess.close()
    del sess
    torch.cuda.empty_cache()
    shutil.rmtree(store, ignore_errors=True)

    # -- a deferred tile flip against the fused gate (auto repair) ---------
    auto = PageRankSession.from_graph(
        hg_df, config=EngineConfig(
            block_size=BLOCK, dtype=torch.float64, tau=TAU,
            integrity=dataclasses.replace(icfg, auto_repair=True)),
        r0=r_df, device="cuda")
    auto.inject_corruption("tile", seed=5, defer=True)
    res = auto.update(*nd_batch, variant="df")
    torch.cuda.synchronize()
    fused = [e for e in auto.report().recovery_events
             if e["domain"] == "corruption"]
    rep = auto.verify()
    after = auto.verify(repair=False)
    err = linf_to(auto.ranks, p3["r_nd"])
    print(f"deferred tile, auto_repair: the fused gate "
          f"{'flagged' if fused else 'did not flag'} it (update "
          f"{res.wall_time_s * 1e3:.2f} ms, host syncs {res.host_syncs}, "
          f"repairs in the update {[e['rung'] for e in fused]}); the next "
          f"verify found {[f['check'] for f in rep.failures]}, repairs "
          f"{rep.repairs}; then clean {after.ok}; L_inf {err:.3e} to phase "
          f"3's nd ranks [{smi}]", flush=True)
    _check(rep.ok and after.ok and not after.failures,
           f"the deferred tile was not healed: {rep.failures}")
    _check(err <= 1e-8, f"deferred tile: ranks off phase 3: {err}")
    auto.close()
    del auto
    torch.cuda.empty_cache()

    # -- a tiered session under the fused gate -----------------------------
    # phase 10's half budget, warm-started from phase 3's opening ranks; its
    # df drives gate mass only once no deferred block is pending
    with warnings.catch_warnings():
        warnings.simplefilter("error", SweepCapWarning)
        t0 = time.perf_counter()
        tiered = PageRankSession.from_graph(
            hg, config=cfg.replace(
                durability="none", device_budget_bytes=budget,
                max_iterations=TIERED_MAX_ITERATIONS),
            r0=p3["r_open"], device="cuda")
        tiered.warmup()
        t_open = time.perf_counter() - t0
        tdf = []
        for dels, ins in batches[:N_CHILD_UPDATES]:
            tdf.append(tiered.update(dels, ins, variant="df"))
            torch.cuda.synchronize()
            _check(tiered._integrity_alert is None, f"the fused gate "
                   f"flagged a clean tiered drive: {tiered._integrity_alert}")
    twalls = np.array([r.wall_time_s for r in tdf]) * 1e3
    e_t = _linf(tiered.ranks, p3[f"r_{N_CHILD_UPDATES}"], n)
    print(f"tiered + integrity= (half budget, warm start): open "
          f"{t_open:.2f} s; df p50 {np.percentile(twalls, 50):.2f} ms over "
          f"{len(tdf)} updates beside phase 10's p50 "
          f"{np.percentile(tier_ms, 50):.2f} ms; host syncs "
          f"{[r.host_syncs for r in tdf]}; fused checks "
          f"{tiered.report().integrity['checks_run']}, no alert; L_inf "
          f"{e_t:.3e} to phase 3's ranks after the same batches [{smi}]",
          flush=True)
    _check(all(r.converged for r in tdf), "a tiered integrity df update "
           "did not converge")
    _check(e_t <= 1e-8, f"tiered integrity ranks off phase 3: {e_t}")
    rep = tiered.verify(repair=False, deep=True)
    r_before = tiered.ranks
    tiered.inject_corruption("rank", seed=11)
    a0 = active()
    rrep = tiered.verify(repair=True, deep=True)
    after = tiered.verify(repair=False, deep=True)
    err = _linf(tiered.ranks, r_before, n)
    print(f"tiered verify(deep), half budget: {rep.wall_time_s:.3f} s clean "
          f"(checks_run {rep.checks_run}; parts (ms) {_ms(rep.split_s)}, "
          f"hot_slab over {int(tiered.hot.resident.sum())} resident "
          f"row-blocks); rank flip found by "
          f"{[f['check'] for f in rrep.failures]}, repairs {rrep.repairs} "
          f"in {rrep.wall_time_s:.3f} s (rung alone "
          f"{_ms(rrep.rung_s)} ms), block_spmv_active launches "
          f"{active() - a0}, then clean {after.ok}, L_inf {err:.3e} to the "
          f"ranks before [{smi}]", flush=True)
    _check(rep.ok and not rep.failures, f"tiered verify not clean: "
           f"{rep.failures}")
    _check(rrep.ok and rrep.repairs == ["frontier"],
           f"the tiered rank flip was not healed at frontier: "
           f"{rrep.repairs}")
    _check(after.ok and err <= 1e-8, f"tiered state after the repair: "
           f"{after.failures}, {err}")
    _check(active() > a0, "the tiered frontier repair launched no "
           "block_spmv_active")
    tiered.close()
    del tiered
    torch.cuda.empty_cache()
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": 0}
    print(f"launches on the integrity path: {launches}; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: serving — PageRankService on per-slot streams
# ---------------------------------------------------------------------------

N_MORE = 8                       # phase 13: batches past phase 3's df run
STALENESS_BUDGET_S = 1.0         # phase 13: the background run's budget
SCRUB_INTERVAL_S = 3.0           # phase 13: > a verify() at n = 1M (~1.8 s)
N_READERS = 3


def _top10(r: np.ndarray, n: int) -> tuple:
    """``top_k(10)`` of host ranks with the port's tie order (a stable
    descending sort: lower id first)."""
    ids = np.argsort(-r[:n], kind="stable")[:10]
    return r[ids], ids


def _serving_phase(bsk, hg, batches, nd_batch, p3: dict, smi: str) -> dict:
    """Phase 13: ``PageRankService`` on phase 3's graph and batches.  A lone
    session takes phase 3's 8 ``df`` batches and ``N_MORE`` more (its ranks
    at every batch index kept on the host; after 8 they must equal phase
    3's bit for bit); then its read view and a ``fork()`` are timed.  A
    synchronous service over a durable slot and an ``integrity=`` slot
    streams the 8 batches (``coalesce=False``; both bit-equal to the lone
    run, no error, retry or dead slot), adds no more card memory than its
    two read views, scrubs a ``rank`` flip at ``frontier`` and runs a brief
    background scrub.  A background service over two fresh slots (a
    durable one killed after 3 dispatches, failed over by the watchdog, and
    a plain one) streams all 16 batches per slot while reader threads read;
    both end bit-equal to the lone run, every read bit-equal to the lone
    run at its view's batch index, every staleness within the budget.  A
    service opened from the host graph folds phase 3's 9 batches into one
    coalesced dispatch, within 1e-8 of phase 3's oracle.  Returns the
    phase's launch counts."""
    from repro_torch.api import (EngineConfig, IntegrityConfig,
                                 PageRankService, PageRankSession,
                                 ServingConfig)
    from repro_torch.core.delta import random_batch

    t_phase = time.perf_counter()
    n = hg.n
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU)
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0

    # -- the lone run: the ranks at every batch index ----------------------
    lone = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    lone.warmup()
    stream_batches, at = [], [lone.ranks]
    for i in range(N_DF_UPDATES + N_MORE):
        if i < N_DF_UPDATES:
            dels, ins = batches[i]
        else:
            dels, ins = random_batch(lone.hg, 1e-4, seed=300 + i,
                                     deletions_frac=0.2)
        stream_batches.append((dels, ins))
        res = lone.update(dels, ins, variant="df")
        _check(res.converged, f"lone update {i} did not converge")
        at.append(lone.ranks)
    _check(bool(np.array_equal(at[N_DF_UPDATES], p3["r_df"])),
           "the lone run differs from phase 3 after its df updates")
    last = len(stream_batches)

    # -- the read view against a fork of the same session ------------------
    reps = 20
    views, walls, dev_ms = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        view = lone._read_view()
        e1.record()
        e1.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
        walls.append((time.perf_counter() - t0) * 1e3)
        views.append(view)
    view_bytes = views[0].nbytes
    del views
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fork = lone.fork()
    torch.cuda.synchronize()
    fork_ms = (time.perf_counter() - t0) * 1e3
    fork_gb = (torch.cuda.memory_allocated() - m0) / 1e9
    fork.close()
    del fork
    lone.close()
    del lone
    torch.cuda.empty_cache()
    print(f"read view refresh: {view_bytes} bytes ({view_bytes / 1e6:.3f} "
          f"MB), device {np.median(dev_ms):.4f}"
          f" ms (median of {reps}), host {np.median(walls):.4f} ms; one "
          f"fork(): {fork_ms:.2f} ms, +{fork_gb:.3f} GB [{smi}]",
          flush=True)
    _check(view_bytes == at[0].nbytes + at[0].shape[0],
           f"the read view holds {view_bytes} bytes, not R + valid")

    # -- synchronous service: a durable slot and an integrity= slot --------
    shutil.rmtree(STORE_ROOT / "serving", ignore_errors=True)
    torch.cuda.synchronize()
    m_base = torch.cuda.memory_allocated()
    icfg = IntegrityConfig(mass_tol=n * TAU, auto_repair=False,
                           scrub_interval_s=SCRUB_INTERVAL_S)
    durable = PageRankSession.from_graph(
        hg, config=cfg.replace(durability="wal"), device="cuda",
        store_dir=str(STORE_ROOT / "serving" / "sync"))
    checked = PageRankSession.from_graph(
        hg, config=cfg.replace(integrity=icfg), device="cuda")
    durable.warmup()
    checked.warmup()
    torch.cuda.synchronize()
    m_sessions = torch.cuda.memory_allocated()
    svc = PageRankService([durable, checked], warmup=False,
                          serving=ServingConfig(coalesce=False, scrub=True))
    torch.cuda.synchronize()
    m_service = torch.cuda.memory_allocated()
    print(f"serving memory: two sessions "
          f"{(m_sessions - m_base) / 1e9:.3f} GB (phase 3's one session x "
          f"2: {2 * p3['mem'] / 1e9:.3f} GB); the "
          f"service adds {(m_service - m_sessions) / 1e6:.3f} MB (2 read "
          f"views of {view_bytes / 1e6:.3f} MB) [{smi}]", flush=True)
    _check(m_service - m_sessions <= 2 * view_bytes + (1 << 20),
           f"the service added {m_service - m_sessions} bytes, more than its "
           "two read views")
    t0 = time.perf_counter()
    for dels, ins in batches:
        for slot in range(2):
            svc.submit(slot, dels, ins)
    svc.run_until_drained()
    t_sync = time.perf_counter() - t0
    rep = svc.report()
    print(f"synchronous service: {rep['requests_done']} requests in "
          f"{t_sync:.2f} s; request p50 {rep['request_p50_ms']} ms, p95 "
          f"{rep['request_p95_ms']} ms; per-slot df p50 "
          f"{[row['p50_ms'] for row in rep['sessions']]} ms [{smi}]",
          flush=True)
    _check(rep["requests_done"] == 2 * N_DF_UPDATES and rep["retries"] == 0
           and not svc._dead, f"synchronous service: {rep['requests_done']}"
           f" done, {rep['retries']} retries, dead {svc._dead}")
    _check(not any(r.error for r in svc.finished), "a synchronous request "
           "carries an error")
    for slot in range(2):
        _check(bool(np.array_equal(svc.sessions[slot].ranks,
                                   at[N_DF_UPDATES])),
               f"synchronous slot {slot} differs from phase 3")
    _check(all(row["retraces_post_warmup"] == 0 for row in rep["sessions"]),
           "a kernel was built during the synchronous run")

    # -- the scrubber: a rank flip found at frontier -----------------------
    before = svc.sessions[1].ranks
    svc.sessions[1].inject_corruption("rank", seed=5)
    t0 = time.perf_counter()
    srep = svc.scrub(1, repair=True)[1]
    t_scrub = time.perf_counter() - t0
    err = _linf(svc.sessions[1].ranks, before, n)
    served = np.asarray(svc.query(1, np.arange(8)))
    print(f"scrub(repair=True): {[f['check'] for f in srep.failures]} -> "
          f"{srep.repairs} in {t_scrub:.3f} s (verify {srep.wall_time_s:.3f}"
          f" s), L_inf {err:.3e} to the ranks before [{smi}]", flush=True)
    _check(srep.ok and srep.repairs == ["frontier"],
           f"the rank flip was not healed at frontier: {srep.repairs}")
    _check(err <= 1e-8, f"ranks after the scrub off: {err}")
    _check(bool(np.array_equal(served, svc.sessions[1].ranks[:8])),
           "the read view was not refreshed after the repair")
    scrubs0 = svc.report()["integrity"]["scrubs_run"]
    t0 = time.perf_counter()
    svc.start()
    try:
        while (svc.report()["integrity"]["scrubs_run"] < scrubs0 + 1
               and time.perf_counter() - t0 < 60):
            time.sleep(0.1)
    finally:
        svc.stop()
    integ = svc.report()["integrity"]
    print(f"background scrub (interval {SCRUB_INTERVAL_S} s): "
          f"{integ['scrubs_run'] - scrubs0} pass(es) in "
          f"{time.perf_counter() - t0:.2f} s; integrity {integ} [{smi}]",
          flush=True)
    _check(integ["scrubs_run"] > scrubs0 and integ["corruption_detected"]
           == 1, f"the background scrubber: {integ}")
    for slot in range(2):
        svc.sessions[slot].close()
    del svc, durable, checked
    torch.cuda.empty_cache()

    # -- background: two fresh slots, a watchdog failover, reader threads --
    durable = PageRankSession.from_graph(
        hg, config=cfg.replace(durability="wal"), device="cuda",
        store_dir=str(STORE_ROOT / "serving" / "background"))
    plain = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    svc = PageRankService(
        [durable, plain],
        serving=ServingConfig(coalesce=False,
                              staleness_budget_s=STALENESS_BUDGET_S))
    _check(len({svc._streams[0], svc._streams[1],
                torch.cuda.current_stream()}) == 3,
           "the slots do not own streams of their own")
    svc.inject_session_fault(0, after_dispatches=3, kind="dead")
    rng = np.random.default_rng(13)
    qids = np.unique(np.concatenate([np.argsort(-at[0][:n])[:16],
                                     rng.integers(0, n, 48)]))
    got, errors, stop = [], [], threading.Event()

    def reader(k: int) -> None:
        r = np.random.default_rng(100 + k)
        try:
            while not stop.is_set():
                slot, box = int(r.integers(2)), {}
                if r.random() < 0.5:
                    def op(v):
                        box["bi"] = v.batch_index
                        return v.query(qids), None
                else:
                    def op(v):
                        box["bi"] = v.batch_index
                        return tuple(v.top_k(10))
                res = svc._read(slot, op)
                got.append((slot, box["bi"], res))
                time.sleep(0.002)
        except Exception as e:      # reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(k,))
               for k in range(N_READERS)]
    t0 = time.perf_counter()
    svc.start()
    for t in threads:
        t.start()
    try:
        for dels, ins in stream_batches:
            for slot in range(2):
                svc.submit(slot, dels, ins)
        svc.run_until_drained()
    finally:
        svc.stop()
        stop.set()
        for t in threads:
            t.join(timeout=60)
    t_bg = time.perf_counter() - t0
    rep = svc.report()
    q = rep["queries"]
    print(f"background service ({N_READERS} reader threads, per-slot "
          f"streams): {rep['requests_done']} requests in {t_bg:.2f} s; "
          f"request p50 {rep['request_p50_ms']} ms, p95 "
          f"{rep['request_p95_ms']} ms; queue wait p50 "
          f"{rep['queue_wait_p50_ms']} ms, p95 {rep['queue_wait_p95_ms']} "
          f"ms; exec p50 {rep['exec_p50_ms']} ms [{smi}]", flush=True)
    print(f"reads: {q['served']} served, p50 {q['p50_ms']} ms, p95 "
          f"{q['p95_ms']} ms; staleness p95 {q['staleness_p95_s']} s, max "
          f"{q['staleness_max_s']} s (budget {STALENESS_BUDGET_S} s), lag "
          f"max {q['lag_updates_max']}; snapshot_refreshes "
          f"{q['snapshot_refreshes']} [{smi}]", flush=True)
    print(f"per-slot df p50 in background "
          f"{[row['p50_ms'] for row in rep['sessions']]} ms beside phase "
          f"3's {np.percentile(p3['df_ms'], 50):.2f} ms [{smi}]", flush=True)
    wd = rep["watchdog"]
    fo = rep["failovers"]
    if fo and wd:
        print(f"failover: recovery_time_s {fo[0]['recovery_time_s']}, "
              f"replayed_batches {fo[0]['replayed_batches']}, "
              f"drained_requests {wd[0]['drained_requests']}, restored at "
              f"batch {fo[0]['restored_batch_index']}; watchdog event "
              f"wall {wd[0]['wall_time_s']:.3f} s [{smi}]", flush=True)
    _check(not errors, f"a reader failed: {errors[:3]}")
    _check(len(fo) == 1 and len(wd) == 1 and wd[0]["kind"] == "dead",
           f"expected one watchdog failover of slot 0: {fo}, {wd}")
    _check(rep["requests_done"] == 2 * last and rep["retries"] == 0
           and not svc._dead, f"background service: "
           f"{rep['requests_done']} done, {rep['retries']} retries, dead "
           f"{svc._dead}")
    erred = [r for r in svc.finished if r.error]
    _check(len(erred) == 1 and erred[0].stream == 0
           and "closed" in erred[0].error,
           f"errors beyond the killed dispatch: "
           f"{[(r.stream, r.error) for r in erred]}")
    for slot in range(2):
        _check(bool(np.array_equal(svc.sessions[slot].ranks, at[last])),
               f"background slot {slot} differs from the lone run")
    tops = {}
    for slot, bi, res in got:
        if res.vertices is None:
            ok = np.array_equal(res.values, at[bi][qids])
        else:
            if bi not in tops:
                tops[bi] = _top10(at[bi], n)
            ok = (np.array_equal(res.values, tops[bi][0])
                  and np.array_equal(res.vertices, tops[bi][1]))
        _check(ok, f"a read of slot {slot} differs from the lone run at "
               f"its view's batch index {bi}")
        _check(res.staleness_s <= STALENESS_BUDGET_S,
               f"a read was {res.staleness_s} s stale")
    _check(len(got) > 0, "no read was served")
    print(f"reads checked: {len(got)}, bit-equal to the lone run at "
          f"{len({bi for _, bi, _ in got})} distinct batch indices",
          flush=True)
    # -- reads of the idle service, one at a time ---------------------------
    few = qids[:4]

    def median_ms(fn, k: int) -> float:
        walls = []
        for _ in range(k):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    q_ms = median_ms(lambda: svc.query(1, few), 50)
    k_ms = median_ms(lambda: svc.top_k(1, 10), 20)
    print(f"idle reads (host wall, median): query of {len(few)} ids "
          f"{q_ms:.4f} ms, top_k(10) {k_ms:.4f} ms [{smi}]", flush=True)
    for slot in range(2):
        svc.sessions[slot].close()
    del svc, durable, plain
    torch.cuda.empty_cache()

    # -- coalescing: phase 3's 9 batches folded into one dispatch ----------
    svc = PageRankService([hg], config=cfg, device="cuda",
                          serving=ServingConfig(coalesce=True))
    for dels, ins in (*batches, nd_batch):
        svc.submit(0, dels, ins)
    svc.start()
    svc.stop()
    rep = svc.report()
    err = _linf(svc.sessions[0].ranks, p3["ref"], n)
    print(f"coalesced: {rep['requests_done']} requests in "
          f"{rep['sessions'][0]['n_updates']} update(s), exec p50 "
          f"{rep['exec_p50_ms']} ms; L_inf {err:.3e} to phase 3's oracle "
          f"[{smi}]", flush=True)
    _check(rep["requests_done"] == N_DF_UPDATES + 1
           and rep["sessions"][0]["n_updates"] == 1,
           f"the coalesced run: {rep['requests_done']} requests, "
           f"{rep['sessions'][0]['n_updates']} updates")
    _check(err <= 1e-8, f"coalesced ranks off the oracle: {err}")
    svc.sessions[0].close()
    del svc
    shutil.rmtree(STORE_ROOT / "serving", ignore_errors=True)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": 0}
    print(f"launches on the serving path: {launches}; phase 13 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    _check(launches["block_spmv"] > 0 and launches["block_spmv_active"] > 0,
           f"the serving path missed a kernel: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the walk engine and PPR on the main path's graph
# ---------------------------------------------------------------------------

WALK_R = 16                      # the walk engine's default walks a vertex
WALK_L = 48                      # ... and walk length
WALK_PARITY_IDS = 4096           # walk_regen held to its plain version
THREEFRY_PAIRS = 1_000_000       # (seed, wid) pairs of the cipher check
CHURN_EDGES = 64                 # deleted and reinserted: walks restored
PPR_SEEDS = (0, 524_800, 1_048_575)
PPR_K = 10
WALK_L1_BOUND = 0.2              # estimate vs phase 3's oracle (~0.07 seen)
# 32-bit integer operations of one threefry2x32 block in walk.cu: 20 rounds
# of (add, rotate, xor) and 2 + 5 * 2 key additions (the key schedule, once
# a walk, is not counted)
THREEFRY_INT_OPS = 72


def _event_ms(fn, setup=None, reps: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs; ``setup`` runs
    before each, outside the timed window."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _scan_entries(rows: torch.Tensor, n: int) -> int:
    """Entries a row scan that stops at a row's first sentinel reads: its
    live prefix and the sentinel, if the row has one."""
    live = (rows < n).sum(1)
    return int((live + (live < rows.shape[1]).long()).sum())


def _int_err(*pairs) -> float:
    """Largest absolute difference over pairs of integer tensors (0 where a
    pair is equal)."""
    err = 0
    for a, b in pairs:
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    return float(err)


def _regen_blocks(rows: torch.Tensor, n: int) -> int:
    """Cipher blocks walk_regen needs for these rows as they come out: one
    for the walk's key (fold_in), two for each step that continues a walk
    and one for the step that ends it (a row of l live entries continued
    l - 1 times and ended once if l < L)."""
    L = rows.shape[1]
    live = (rows < n).sum(1)
    return int((1 + 2 * (live - 1) + (live < L).long()).sum())


def _regen_bytes(new: torch.Tensor, n: int, cap: int,
                 old: torch.Tensor = None) -> int:
    """Bytes walk_regen must move to turn rows ``old`` (all sentinel when
    None, as at the open) into rows ``new``: the id list; each old row up
    to its first sentinel; the entries that change, a row's first
    max(l_old, l_new) (past both every entry is n already); each visited
    vertex's count, read and written; the adjacency row and degree of each
    vertex a walk stepped from."""
    B, L = new.shape
    l_new = (new < n).sum(1)
    if old is None:
        scan, l_old, seen = B, torch.zeros_like(l_new), new[new < n]
    else:
        scan, l_old = _scan_entries(old, n), (old < n).sum(1)
        seen = torch.cat([old[old < n], new[new < n]])
    stepped = new[:, :-1][new[:, 1:] < n]
    return int(4 * B + 4 * scan + 4 * int(torch.maximum(l_old, l_new).sum())
               + 8 * seen.unique().numel()
               + (4 * cap + 4) * stepped.unique().numel())


def _walk_kernel_checks(wk, threefry, ws, touched: np.ndarray,
                        smi: str) -> list:
    """Phase 14, part 1: each walk kernel held to its plain version on the
    card at the main path's shapes (exact), the device cipher to the plain
    threefry on ``THREEFRY_PAIRS`` (seed, wid) pairs, and both kernels
    timed beside their work bounds: ``walk_touch`` on one batch's touched
    set, ``walk_regen`` on the walks it flags and over every walk (the
    open, the kernel-table row).  Returns the kernel-table rows (their
    launches are filled in by the caller)."""
    n, R, L = ws.n, ws.R, ws.L
    nr = n * R
    dev = ws.walks.device
    rng = np.random.default_rng(14)
    # -- the cipher: fold_in keys of (seed, wid) pairs, then draw words ------
    seeds = rng.integers(0, 1 << 40, THREEFRY_PAIRS, dtype=np.int64)
    k0 = torch.as_tensor(seeds >> 32, device=dev)
    k1 = torch.as_tensor(seeds & 0xFFFFFFFF, device=dev)
    zero = torch.zeros(THREEFRY_PAIRS, dtype=torch.int64, device=dev)
    wid = torch.as_tensor(rng.integers(0, 1 << 31, THREEFRY_PAIRS),
                          device=dev)
    ctr = torch.as_tensor(rng.integers(0, 2 * L, THREEFRY_PAIRS), device=dev)
    kc = wk.threefry_words_cuda(k0, k1, zero, wid)
    kp = threefry.threefry2x32((k0, k1), zero, wid)
    dc = wk.threefry_words_cuda(kc[0], kc[1], zero, ctr)
    dp = threefry.threefry2x32(kp, zero, ctr)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(kc + dc, kp + dp)),
           "the device cipher differs from the plain threefry")
    print(f"threefry: {THREEFRY_PAIRS} (seed, wid) fold_in keys and draw "
          "words on the card equal the plain version", flush=True)

    # -- walk_regen on the walks through the degree-7 vertices, filled up to
    # WALK_PARITY_IDS with walks through the degree-6 ones, and the last id
    dmax = int(ws.deg[:n].max())
    picked = []
    for d in (dmax, dmax - 1):
        tm = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        tm[:n] = ws.deg[:n] == d
        flags, _ = wk.walk_touch_cuda(ws.walks, tm, n_walks=nr)
        picked.append(flags.nonzero().reshape(-1))
    fill = picked[1][~torch.isin(picked[1], picked[0])]
    ids = torch.cat([picked[0], fill])[:WALK_PARITY_IDS - 1]
    ids = torch.cat([ids.sort().values, torch.tensor([nr - 1], device=dev)]
                    ).to(torch.int32)
    _check(int(ids.shape[0]) == WALK_PARITY_IDS,
           f"only {int(ids.shape[0])} walk ids for the walk_regen check")
    adj = ws.adj.clone()            # those rows reversed: the walks move
    for d in (dmax, dmax - 1):
        hubs = (ws.deg[:n] == d).nonzero().reshape(-1)
        adj[hubs, :d] = adj[hubs, :d].flip(1)
    outs, regen_ms = [], []
    for fn in (wk.walk_regen_cuda, wk.walk_regen_plain):
        w, c = ws.walks.clone(), ws.counts.clone()
        box = {}
        regen_ms.append(_event_ms(
            lambda: box.update(s=fn(w, c, adj, ws.deg, ids, R=R,
                                    alpha=ws._alpha32, key=ws._key)),
            reps=1))
        outs.append((w, c, int(box["s"])))
    regen_err = _int_err((outs[0][0], outs[1][0]), (outs[0][1], outs[1][1]))
    regen_err = max(regen_err, float(abs(outs[0][2] - outs[1][2])))
    _check(regen_err == 0.0, "walk_regen differs from its plain version")
    moved = int((outs[0][0][ids.long()] != ws.walks[ids.long()]).any(1)
                .sum())
    _check(moved > 0, "the reversed rows changed no walk")
    print(f"walk_regen: {int(ids.shape[0])} walk ids ({len(picked[0])} "
          f"through the vertices of out-degree {dmax}, the rest through "
          f"those of out-degree {dmax - 1}, and the last id) with those "
          f"vertices' rows reversed: walks, counts and steps "
          f"({outs[0][2]}) equal the plain version; {moved} walks moved; "
          f"{regen_ms[0]:.4f} ms, plain {regen_ms[1]:.1f} ms [{smi}]",
          flush=True)
    del outs, w, c, adj, box

    # -- walk_touch on one batch's touched set --------------------------------
    tm = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    tm[torch.as_tensor(touched, device=dev)] = True
    f1, m1 = wk.walk_touch_cuda(ws.walks, tm, n_walks=nr)
    t0 = time.perf_counter()
    f2, m2 = wk.walk_touch_plain(ws.walks, tm, n_walks=nr)
    torch.cuda.synchronize()
    touch_plain_ms = (time.perf_counter() - t0) * 1e3
    touch_err = max(_int_err((f1, f2)), float(abs(int(m1) - int(m2))))
    _check(touch_err == 0.0, "walk_touch differs from its plain version")
    touch_ms = _event_ms(lambda: wk.walk_touch_cuda(ws.walks, tm,
                                                    n_walks=nr), reps=5)
    entries = _scan_entries(ws.walks[:nr], n)
    touch_bytes = 4 * entries + (n + 1) + nr
    touch_bound = touch_bytes / HBM_BYTES_PER_S * 1e3
    print(f"walk_touch: {len(touched)} touched vertices, {int(f1.sum())} "
          f"walks flagged, mass {int(m1)}: equal the plain version; "
          f"{touch_ms:.4f} ms (bound {touch_bound:.4f} ms by bytes: "
          f"{touch_bytes} bytes, {entries} row entries read), plain "
          f"{touch_plain_ms:.1f} ms [{smi}]", flush=True)

    # -- walk_regen on the walks that batch flags, on the open's adjacency:
    # each row is rewritten as it was, so both routes must give the open's
    df_ids = f1.nonzero().reshape(-1).to(torch.int32)
    B = int(df_ids.shape[0])
    rows = ws.walks[df_ids.long()]
    outs = []
    for fn in (wk.walk_regen_cuda, wk.walk_regen_plain):
        w, c = ws.walks.clone(), ws.counts.clone()
        s = fn(w, c, ws.adj, ws.deg, df_ids, R=R, alpha=ws._alpha32,
               key=ws._key)
        outs.append((w, c, int(s)))
    df_err = max(_int_err((outs[0][0], outs[1][0]), (outs[0][1], outs[1][1]),
                          (outs[0][0], ws.walks), (outs[0][1], ws.counts)),
                 float(abs(outs[0][2] - outs[1][2])))
    _check(df_err == 0.0, "walk_regen on a df batch's walks differs from "
           "its plain version or from the open's rows")
    w, c = outs[0][0], outs[0][1]
    df_ms = _event_ms(lambda: wk.walk_regen_cuda(
        w, c, ws.adj, ws.deg, df_ids, R=R, alpha=ws._alpha32, key=ws._key),
        reps=5)
    df_plain_ms = _event_ms(lambda: wk.walk_regen_plain(
        w, c, ws.adj, ws.deg, df_ids, R=R, alpha=ws._alpha32, key=ws._key),
        reps=1)
    df_bytes = _regen_bytes(rows, n, ws.adj.shape[1], old=rows)
    df_ops = THREEFRY_INT_OPS * _regen_blocks(rows, n)
    df_bound, df_by = max((df_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                          (df_ops / INT32_OPS * 1e3, "operations"))
    print(f"walk_regen, one df batch: the {B} walks walk_touch flagged "
          f"({int(outs[0][2])} live entries), on the open's adjacency: "
          f"walks, counts and steps equal the plain version and the open's "
          f"rows; {df_ms:.4f} ms (bound {df_bound:.4f} ms by {df_by}: "
          f"{df_bytes} bytes, {df_ops} cipher int32 operations), plain "
          f"{df_plain_ms:.1f} ms [{smi}]", flush=True)
    regen_err = max(regen_err, df_err)
    del f1, f2, outs, w, c, rows

    # -- the open's regeneration: every walk from sentinel rows --------------
    all_ids = torch.arange(nr, dtype=torch.int32, device=dev)
    w, c = torch.empty_like(ws.walks), torch.empty_like(ws.counts)

    def fresh():
        w.fill_(n)
        c.zero_()

    open_ms = _event_ms(
        lambda: wk.walk_regen_cuda(w, c, ws.adj, ws.deg, all_ids, R=R,
                                   alpha=ws._alpha32, key=ws._key),
        setup=fresh)
    full_err = _int_err((w, ws.walks), (c, ws.counts))
    _check(full_err == 0.0, "a full walk_regen differs from the open's")
    plain_open_ms = _event_ms(
        lambda: wk.walk_regen_plain(w, c, ws.adj, ws.deg, all_ids, R=R,
                                    alpha=ws._alpha32, key=ws._key),
        setup=fresh, reps=1)
    plain_err = _int_err((w, ws.walks), (c, ws.counts))
    _check(plain_err == 0.0,
           "the plain full regeneration differs from the open's")
    regen_err = max(regen_err, full_err, plain_err)
    live = ws.total_steps
    open_bytes = _regen_bytes(ws.walks[:nr], n, ws.adj.shape[1])
    # a walk of l live entries draws at min(l, L - 1) steps
    draw_steps = int((ws.walks[:nr] < n).sum(1).clamp(max=L - 1).sum())
    open_ops = THREEFRY_INT_OPS * _regen_blocks(ws.walks[:nr], n)
    t_bytes = open_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = open_ops / INT32_OPS * 1e3
    open_bound, open_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    print(f"walk_regen, the open: all {nr} walks ({live} live entries, "
          f"{live / nr:.3f} a walk, {draw_steps} steps that draw) "
          f"{open_ms:.3f} ms (bound {open_bound:.4f} ms by {open_by}: "
          f"{open_bytes} bytes {t_bytes:.4f} ms, {open_ops} cipher int32 "
          f"operations {t_ops:.4f} ms), plain {plain_open_ms:.1f} ms; "
          f"equal the open's walks and counts [{smi}]", flush=True)
    del w, c, all_ids
    torch.cuda.empty_cache()
    return [
        dict(name="walk_regen", route="cuda",
             source="src/repro_torch/kernels/walk/csrc/walk.cu",
             replaces="src/repro/core/walk_engine.py:70 (_regen_step, "
             "lax.scan, no Pallas kernel)",
             launches=0, max_abs_err=regen_err, ms=open_ms,
             plain_ms=plain_open_ms, bound_ms=open_bound, bound_by=open_by,
             library_ms=None),
        dict(name="walk_touch", route="cuda",
             source="src/repro_torch/kernels/walk/csrc/walk.cu",
             replaces="src/repro/core/walk_engine.py:240 (the host reverse "
             "index, no Pallas kernel)",
             launches=0, max_abs_err=touch_err, ms=touch_ms,
             plain_ms=touch_plain_ms, bound_ms=touch_bound,
             bound_by="bytes", library_ms=None)]


def _numpy_ppr(rows: np.ndarray, n: int, n_seeds: int, k: int):
    """The personalized top-k folded on the host from the seeds' walk rows:
    visit counts times (1 - alpha_f32) · 1/(|S|·R), ties lower id first."""
    cnt = np.bincount(rows[rows < n], minlength=n).astype(np.float64)
    scale = (np.float64(np.float32(1.0) - np.float32(0.85))
             * (1.0 / np.float64(n_seeds * WALK_R)))
    vals = cnt * scale
    order = np.lexsort((np.arange(n), -vals))[:k]
    return vals[order], order


def _walk_phase(bsk, bws, hg, batches, nd_batch, ref, smi: str) -> tuple:
    """Phase 14: the walk engine on phase 3's graph at full width (R = 16,
    L = 48, f64).  Part 1 holds the kernels to their plain versions and
    times them; then the launch counters are zeroed and the main path runs:
    a walk session opens (one walk_regen over every walk), warms up and
    takes phase 3's 8 df batches and its nd batch; its walks and counts
    must equal a fresh store on the final graph, a delete and reinsert of
    ``CHURN_EDGES`` edges must restore both, its estimate must lie within
    ``WALK_L1_BOUND`` of phase 3's oracle (L1), ``ppr_query`` must equal a
    numpy fold of the seeds' rows, a save and restore must give the same
    walks, and a one-slot walk service must serve degraded ``ppr_query``
    reads equal to the lone session's at the view's batch index.  Returns
    the phase's launch counts and the kernel-table rows."""
    from repro_torch.api import EngineConfig, PageRankService, PageRankSession
    from repro_torch.core import threefry
    from repro_torch.core import walk_engine as we
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.walk import walk as wk

    t_phase = time.perf_counter()
    n = hg.n
    nr = n * WALK_R
    dels0, ins0 = batches[0]
    touched = np.unique(np.concatenate([dels0[:, 0], ins0[:, 0]]))
    ws = we.WalkState(hg, R=WALK_R, L=WALK_L, seed=0, device="cuda")
    rows = _walk_kernel_checks(wk, threefry, ws, touched, smi)
    del ws
    torch.cuda.empty_cache()

    # -- the main path, counters zeroed -------------------------------------
    for fn in (wk.walk_regen_cuda, wk.walk_touch_cuda, bsk.block_spmv_cuda,
               bsk.block_spmv_active_cuda, bws.blocked_sweep_cuda):
        fn.launches = 0
    cfg = EngineConfig(engine="walk", dtype=torch.float64,
                       walks_per_vertex=WALK_R, walk_length=WALK_L,
                       walk_seed=0)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated() - mem0
    dev_bytes = sess.report().device_bytes
    print(f"walk session open: {t_open:.2f} s (one walk_regen over {nr} "
          f"walks); card memory {mem / 1e9:.3f} GB (walks "
          f"{sess.walks.walks.nbytes / 1e9:.3f} GB, adjacency "
          f"{sess.walks.adj.nbytes / 1e6:.1f} MB, counts and degrees "
          f"{(sess.walks.counts.nbytes + sess.walks.deg.nbytes) / 1e6:.1f} "
          f"MB); report().device_bytes {dev_bytes} [{smi}]", flush=True)
    sess.warmup()
    builds0 = nvcc.total_builds()
    lone = {0: sess.ppr_query(PPR_SEEDS, PPR_K)}
    df = []
    for i, (dels, ins) in enumerate(batches):
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        df.append(res)
        lone[i + 1] = sess.ppr_query(PPR_SEEDS, PPR_K)
        print(f"walk df update {i}: {len(dels)} del + {len(ins)} ins, "
              f"{res.wall_time_s * 1e3:.2f} ms, regenerated "
              f"{res.regenerated_walks}, touched {res.touched_walks}, total "
              f"{res.total_walks}, steps {res.stats.edges_processed}, host "
              f"syncs {res.host_syncs}", flush=True)
    nd = sess.update(*nd_batch, variant="nd")
    torch.cuda.synchronize()
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    print(f"walk nd update: {nd.wall_time_s * 1e3:.2f} ms, regenerated "
          f"{nd.regenerated_walks}, touched {nd.touched_walks}, steps "
          f"{nd.stats.edges_processed}; df wall p50 "
          f"{np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms over {len(walls)} updates; "
          f"kernel builds after warmup {nvcc.total_builds() - builds0} "
          f"[{smi}]", flush=True)
    _check(nvcc.total_builds() == builds0
           and sess.report().retraces_post_warmup == 0,
           "a kernel was built after the walk session's warmup")
    for r in df + [nd]:
        _check(0 < r.regenerated_walks <= r.touched_walks
               and r.regenerated_walks < r.total_walks == nr,
               f"an update was not delta-localized: {r.regenerated_walks} "
               f"regenerated, {r.touched_walks} touched")

    # -- incremental equals full; the estimate against the oracle -----------
    fresh = we.WalkState(sess.hg, R=WALK_R, L=WALK_L, seed=0,
                         device="cuda")
    _check(torch.equal(fresh.walks, sess.walks.walks)
           and torch.equal(fresh.counts, sess.walks.counts),
           "the updated walks differ from a fresh store on the final graph")
    del fresh
    torch.cuda.empty_cache()
    est = sess.ranks
    l1 = float(np.abs(est - ref[:n]).sum())
    visits = sess.walks.total_steps / n
    print(f"walk estimate: L1 {l1:.4f} to phase 3's oracle ({visits:.1f} "
          f"visits a vertex); incremental walks and counts equal a fresh "
          f"store on the final graph [{smi}]", flush=True)
    _check(bool(np.isfinite(est).all()) and est.shape == (n,),
           "the walk estimate is not finite or of the wrong shape")
    _check(l1 < WALK_L1_BOUND, f"walk estimate L1 {l1} >= {WALK_L1_BOUND}")

    # -- a delete and reinsert restores the walks -----------------------------
    w0, c0 = sess.walks.walks.clone(), sess.walks.counts.clone()
    churn = sess.hg.edges[np.random.default_rng(15).choice(
        sess.hg.m, CHURN_EDGES, replace=False)]
    none = np.zeros((0, 2), np.int64)
    cut = sess.update(churn, none)
    moved = not torch.equal(w0, sess.walks.walks)
    back = sess.update(none, churn)
    _check(moved and torch.equal(w0, sess.walks.walks)
           and torch.equal(c0, sess.walks.counts),
           "a delete and reinsert did not restore the walks exactly")
    print(f"walk churn: {CHURN_EDGES} edges deleted ({cut.regenerated_walks}"
          f" walks regenerated) and reinserted ({back.regenerated_walks}): "
          "walks and counts restored exactly", flush=True)
    del w0, c0

    # -- ppr_query against a numpy fold of the seeds' rows -------------------
    ppr_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, ids = sess.ppr_query(PPR_SEEDS, PPR_K)
        ppr_s.append(time.perf_counter() - t0)
    seed_rows = (np.asarray(PPR_SEEDS)[:, None] * WALK_R
                 + np.arange(WALK_R)[None, :]).reshape(-1)
    host_rows = sess.walks.walks[torch.as_tensor(
        seed_rows, device="cuda")].cpu().numpy()
    nv, ni = _numpy_ppr(host_rows, n, len(PPR_SEEDS), PPR_K)
    _check(np.array_equal(vals, nv) and np.array_equal(ids, ni),
           "ppr_query differs from the numpy fold of the seeds' walks")
    print(f"ppr_query({list(PPR_SEEDS)}, k={PPR_K}): median "
          f"{np.median(ppr_s) * 1e3:.2f} ms wall; top ids {ids.tolist()} "
          f"equal the numpy fold [{smi}]", flush=True)

    # -- save and restore -----------------------------------------------------
    store = STORE_ROOT / "walk"
    shutil.rmtree(store, ignore_errors=True)
    sess.save(str(store))
    t0 = time.perf_counter()
    rest = PageRankSession.restore(str(store), device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    _check(torch.equal(rest.walks.walks, sess.walks.walks)
           and torch.equal(rest.walks.counts, sess.walks.counts),
           "the restored walks differ from the saved session's")
    print(f"walk save + restore: restore {t_restore:.2f} s, walks and "
          f"counts equal [{smi}]", flush=True)
    rest.close()
    sess.close()
    del rest, sess
    shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- a one-slot walk service ------------------------------------------------
    svc = PageRankService([hg], config=cfg, device="cuda")
    for i, (dels, ins) in enumerate(batches):
        svc.submit(0, dels, ins)
        while svc.step():
            pass
        r = svc.ppr_query(0, PPR_SEEDS, PPR_K)
        at = svc._snapshots[0].sess.batch_index
        _check(r.degraded and np.array_equal(r.values, lone[at][0])
               and np.array_equal(r.vertices, lone[at][1]),
               f"the service's ppr_query after batch {i} differs from the "
               f"lone session's at batch index {at}")
    torch.cuda.synchronize()
    with svc._slot_locks[0]:
        t0 = time.perf_counter()
        svc._refresh_snapshot(0)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) * 1e3
    view_bytes = svc._snapshots[0].sess.nbytes
    rep = svc.report()
    print(f"walk service: {rep['requests_done']} requests, every degraded "
          f"ppr_query equal to the lone session's at its view's batch "
          f"index; read-view refresh {refresh_ms:.2f} ms for {view_bytes} "
          f"bytes; query p50 {rep['queries']['p50_ms']} ms [{smi}]",
          flush=True)
    svc.stop()
    svc.sessions[0].close()
    del svc
    torch.cuda.empty_cache()
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches,
                "blocked_sweep": bws.blocked_sweep_cuda.launches,
                "walk_regen": wk.walk_regen_cuda.launches,
                "walk_touch": wk.walk_touch_cuda.launches}
    print(f"launches on the walk path: {launches}; phase 14 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    _check(launches["walk_regen"] > 0 and launches["walk_touch"] > 0,
           f"the walk path missed a kernel: {launches}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    return launches, rows


# ---------------------------------------------------------------------------
# phase 15: the sharded session on the main path's graph
# ---------------------------------------------------------------------------

N_SHARDS = 8
DELTA_CAPACITY = 4096            # the runtime-level delta exchange
SMALL_TAU = 1e-7                 # the CPU tests' bf16 run (rmat(10), f32)


def _mem_gb(mem0: int) -> float:
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated() - mem0) / 1e9


def _sharded_stream(bsk, hg, batches, nd_batch, cfg, p3: dict,
                    smi: str) -> tuple:
    """One 8-shard session opened cold on phase 3's graph, streamed through
    phase 3's 8 df batches (each held to phase 3's ranks after the same
    batch, kernel #1 launched 16 times a sweep), the df replay of the last
    one (bit for bit) and the nd batch.  Returns the open session and its
    host ranks after each batch, sweeps and exchange counts."""
    from repro_torch.api.session import PageRankSession
    name = f"sharded {cfg.exchange}"
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    r_open = sess.ranks
    e_open = _linf(r_open, p3["r_open"], sess.n)
    # the cold solve's counters: a static re-solve repeats it bit for bit
    st = sess.recompute("static")
    torch.cuda.synchronize()
    _check(bool(np.array_equal(sess.ranks, r_open)),
           f"{name}: recompute('static') differs from the cold open")
    mem = _mem_gb(mem0)
    rt = sess.runtime
    tiles = [m.n_tiles() for m in rt.dg.mats]
    print(f"{name} open (partition {sess._partition_s:.2f} s, cold solve): "
          f"{t_open:.2f} s; L_inf {e_open:.3e} to phase 3's opening ranks; "
          f"static re-solve {st.stats.sweeps} sweeps in "
          f"{st.wall_time_s * 1e3:.1f} ms, bit-equal; live tiles per shard "
          f"{min(tiles)}-{max(tiles)}, capacity "
          f"{rt.dg.mats[0].tile_capacity}; card memory {mem:.3f} GB beside "
          f"phase 3's session {p3['mem'] / 1e9:.3f} GB [{smi}]", flush=True)
    _check(st.stats.converged and e_open <= 1e-8,
           f"{name}: the cold open is {e_open} off phase 3's")
    sess.warmup()
    out = {"ranks": [], "sweeps": [], "walls": [], "syncs": [], "edges": []}
    for i, (dels, ins) in enumerate(batches):
        before = (bsk.block_spmv_cuda.launches,
                  bsk.block_spmv_active_cuda.launches)
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        r = sess.ranks
        err = _linf(r, p3["r_batches"][i], sess.n)
        out["ranks"].append(r)
        for k, v in (("sweeps", res.stats.sweeps),
                     ("walls", res.wall_time_s * 1e3),
                     ("syncs", res.host_syncs),
                     ("edges", res.stats.edges_processed)):
            out[k].append(v)
        launched = bsk.block_spmv_cuda.launches - before[0]
        print(f"{name} df update {i}: {res.wall_time_s * 1e3:.2f} ms, "
              f"sweeps {res.stats.sweeps} (phase 3: {p3['sweeps'][i]}), "
              f"edges {res.stats.edges_processed}, host syncs "
              f"{res.host_syncs}, kernel #1 launches {launched}; L_inf "
              f"{err:.3e} to phase 3's", flush=True)
        _check(res.converged and err <= 1e-8,
               f"{name}: df update {i} is {err} off phase 3's")
        _check(launched == 2 * N_SHARDS * res.stats.sweeps
               and bsk.block_spmv_active_cuda.launches == before[1],
               f"{name}: df update {i} launched {launched} kernel #1 over "
               f"{res.stats.sweeps} sweeps")
    last = res.ranks
    replay = sess.recompute("df")
    torch.cuda.synchronize()
    _check(bool(torch.equal(replay.ranks, last)),
           f"{name}: recompute('df') differs from the last df update")
    nd = sess.update(*nd_batch, variant="nd")
    torch.cuda.synchronize()
    out["ranks"].append(sess.ranks)
    out["sweeps"].append(nd.stats.sweeps)
    e_nd = _linf(out["ranks"][-1], p3["r_nd"], sess.n)
    e_ref = _linf(out["ranks"][-1], p3["ref"], sess.n)
    rep = sess.report()
    walls = np.array(out["walls"])
    out["x"] = (sess._x_full, sess._x_delta)
    out["mem"] = mem
    print(f"{name}: replay bit-equal ({replay.stats.sweeps} sweeps); nd "
          f"{nd.stats.sweeps} sweeps, L_inf {e_nd:.3e} to phase 3's nd and "
          f"{e_ref:.3e} to its oracle; df p50 "
          f"{np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms (phase 3: p50 "
          f"{np.percentile(p3['df_ms'], 50):.2f} ms); host syncs "
          f"{out['syncs']} (phase 3: {p3['syncs']}); edge_cut "
          f"{rep.edge_cut:.6f}; collective bytes a sweep (wire model) "
          f"{rep.collective_bytes_per_sweep:.4g}; exchanges full/delta "
          f"{out['x'][0]}/{out['x'][1]}; kernel builds after warmup "
          f"{rep.retraces_post_warmup} [{smi}]", flush=True)
    _check(nd.converged and e_nd <= 1e-8 and e_ref <= 1e-8,
           f"{name}: the nd update is {e_nd} off phase 3's, {e_ref} off "
           "its oracle")
    _check(rep.retraces_post_warmup == 0, f"{name}: a build after warmup")
    vals, ids = sess.top_k(10)
    _check(bool(np.array_equal(sess.query(ids), vals)),
           f"{name}: query != top_k values")
    _check(float(np.abs(vals - p3["ref"][ids]).max()) <= 1e-8,
           f"{name}: top_k values off the oracle")
    return sess, out


def _shard_kernel_checks(bsk, ops, mat, n_pad: int, smi: str) -> None:
    """Kernel #1 on one shard's matrix, sum and or, against its plain
    version on the card (≤ 1e-12 for sum, exact for or) and timed beside
    its bound (the fewest bytes of the matrix, the x entries of its live
    column blocks, y); the launches are not the path's."""
    saved = (bsk.block_spmv_cuda.launches,
             bsk.block_spmv_active_cuda.launches)
    g = torch.Generator(device="cuda").manual_seed(15)
    x = torch.rand(n_pad, dtype=torch.float64, device="cuda",
                   generator=g) * 1e-6
    flags = (torch.rand(n_pad, device="cuda", generator=g) < 0.05).double()
    nnz = int(mat.index.cnt.sum())
    live = mat.n_tiles()
    # x is read only in the column blocks of the shard's live tiles
    tc = mat.tile_cols_h
    x_cols = len(np.unique(tc[tc >= 0])) * mat.block
    for semiring, xv in (("sum", x), ("or", flags)):
        y = ops.block_spmv(mat, xv, semiring=semiring)
        yp = bsk.block_spmv_plain(
            mat.tile_idx, mat.tile_cols, mat.tiles, ops._pad_x(mat, xv),
            block=mat.block, max_tiles=mat.max_tiles,
            semiring=semiring)[:mat.n_rows]
        err = float((y - yp).abs().max())
        ms = _time_ms(lambda: ops.block_spmv(mat, xv, semiring=semiring), 50)
        plain_ms = _event_ms(lambda: bsk.block_spmv_plain(
            mat.tile_idx, mat.tile_cols, mat.tiles, ops._pad_x(mat, xv),
            block=mat.block, max_tiles=mat.max_tiles, semiring=semiring))
        bound_ms, by = _bound(
            _work_bytes(nnz, mat.n_rows, live, 8) + x_cols * 8
            + mat.n_rows * 8, 2 * nnz)
        print(f"shard 0 kernel #1 ({semiring}): {mat.n_rows} rows x "
              f"{n_pad} columns, {nnz} nonzeros in {live} tiles reading "
              f"{x_cols} entries of x; "
              f"{ms:.4f} ms (plain {plain_ms:.3f} ms), bound {bound_ms:.4f} "
              f"ms ({by}); max_abs_err {err:.3e} [{smi}]", flush=True)
        _check(err <= (1e-12 if semiring == "sum" else 0.0),
               f"shard kernel #1 ({semiring}) off its plain version: {err}")
    (bsk.block_spmv_cuda.launches,
     bsk.block_spmv_active_cuda.launches) = saved


def _runtime_delta(hg, batches, p3: dict, smi: str) -> None:
    """The delta exchange at capacity ``DELTA_CAPACITY`` (no config carries
    a capacity; the session's is 1024): a ``full`` and a ``delta``
    runtime on phase 3's graph, relabeled contiguously, take phase 3's df
    batches as the session does (the effective batch, the O(batch) seeds)
    from the same ranks.  After every batch the two are bit-equal with
    equal sweeps and within 1e-8 of phase 3's ranks; the sweeps that took
    the delta path are counted."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.incremental import effective_batch
    from repro_torch.graphs import partition as gpart
    order, inv, _ = gpart.make_partition(hg, N_SHARDS, "contiguous")
    hg_rel, _ = gpart.relabel(hg, order)
    mesh = dist.ShardMesh.on("cuda", N_SHARDS)
    rts = {ex: dist.DistRuntime(hg_rel, mesh, tau=TAU, exchange=ex,
                                delta_capacity=DELTA_CAPACITY, block=BLOCK)
           for ex in ("full", "delta")}
    R = torch.zeros(rts["full"].n_pad, dtype=torch.float64, device="cuda")
    R[:hg.n] = torch.from_numpy(p3["r_open"][:hg.n][order]).cuda()
    tally = {ex: [0, 0, 0.0] for ex in rts}    # full, delta, seconds
    sweeps = []
    for i, (dels, ins) in enumerate(batches):
        d_rel, i_rel = inv[dels], inv[ins]
        d_eff, i_eff = effective_batch(hg_rel, d_rel, i_rel)
        hg_new = hg_rel.apply_batch(d_rel, i_rel)
        idx = dist.df_seed_indices(
            hg_rel, hg_new, np.concatenate([d_rel[:, 0], i_rel[:, 0]]))
        hg_rel = hg_new
        out = {}
        for ex, rt in rts.items():
            t0 = time.perf_counter()
            rt.apply_batch(d_eff, i_eff)
            out[ex] = rt.drive(R, rt.mask_from_indices(idx), expand=True)
            torch.cuda.synchronize()
            tally[ex][0] += out[ex][1].full_exchanges
            tally[ex][1] += out[ex][1].delta_exchanges
            tally[ex][2] += time.perf_counter() - t0
        (Rf, sf), (Rd, sd) = out["full"], out["delta"]
        err = _linf(Rf.cpu().numpy()[inv], p3["r_batches"][i], hg.n)
        _check(sf.converged and bool(torch.equal(Rf, Rd))
               and sf.sweeps == sd.sweeps and err <= 1e-8,
               f"runtime delta ({DELTA_CAPACITY}) batch {i}: bit-equal "
               f"{torch.equal(Rf, Rd)}, sweeps {sd.sweeps} vs {sf.sweeps}, "
               f"{err} off phase 3's")
        sweeps.append(sf.sweeps)
        R = Rf
    print(f"runtime delta at capacity {DELTA_CAPACITY} vs full ({len(batches)} df "
          f"batches, contiguous): ranks bit-equal and sweeps equal after "
          f"every batch; sweeps {sweeps}; exchanges full/delta "
          f"{tally['delta'][0]}/{tally['delta'][1]} (the full runtime "
          f"{tally['full'][0]}/{tally['full'][1]}); batch + drive "
          f"{tally['delta'][2] * 1e3:.1f} ms vs full "
          f"{tally['full'][2] * 1e3:.1f} ms over the 8 [{smi}]", flush=True)


def _small_runs(smi: str) -> None:
    """``tests/test_distributed.py``'s graph and batch (rmat(10), 8
    shards): the bf16 run (f32, τ = 1e-7) on the card within the JAX test's
    1e-4 of the oracle, its counters beside the same call on the CPU; the
    delta run (capacity 4096) makes delta exchanges."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.delta import random_batch
    from repro_torch.core.frontier import batch_to_device, initial_affected
    from repro_torch.core.pagerank import numpy_reference
    from repro_torch.graphs.generators import rmat
    hg0 = rmat(10, avg_degree=8, seed=3)
    g0 = hg0.snapshot(block_size=64, device="cpu")
    ref0 = numpy_reference(g0, iterations=300)
    dels, ins = random_batch(hg0, 1e-3, seed=11)
    hg1 = hg0.apply_batch(dels, ins)
    g1 = hg1.snapshot(block_size=64, device="cpu")
    ref1 = numpy_reference(g1, iterations=300)[:hg1.n]
    aff0 = initial_affected(g0, g1, batch_to_device(g1, dels, ins))
    got = {}
    for dev in ("cuda", "cpu"):
        for kw in (dict(exchange="bf16", tau=SMALL_TAU, dtype=torch.float32),
                   dict(exchange="delta", delta_capacity=4096)):
            R, st = dist.run_distributed(
                hg1, dist.ShardMesh.on(dev, N_SHARDS),
                r_prev=torch.from_numpy(ref0), affected0=aff0, expand=True,
                **kw)
            got[dev, kw["exchange"]] = (
                st, float(np.abs(R.cpu().numpy()[:hg1.n] - ref1).max()))
    for ex, tol in (("bf16", 1e-4), ("delta", 1e-8)):
        (sg, eg), (sc, ec) = got["cuda", ex], got["cpu", ex]
        print(f"rmat(10), 8 shards, {ex}: card {sg} L_inf {eg:.3e}; CPU "
              f"plain {sc} L_inf {ec:.3e} [{smi}]", flush=True)
        _check(sg.converged and eg < tol,
               f"rmat(10) {ex} on the card: {sg}, L_inf {eg}")
    _check(got["cuda", "delta"][0].delta_exchanges > 0,
           "rmat(10) delta on the card made no delta exchange")


def _sharded_phase(bsk, ops, hg, hg_ref, batches, nd_batch, p3: dict,
                   smi: str) -> dict:
    """Phase 15: 8-shard sessions on phase 3's graph and batches, launch
    counters zeroed just before and read at the end (the kernel checks
    against the plain version excluded).  Returns the launches."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    t_phase = time.perf_counter()
    base = dict(topology="sharded", n_shards=N_SHARDS, block_size=BLOCK,
                dtype=torch.float64, tau=TAU)
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    # -- the full exchange: cold open, stream, replay, nd --------------------
    sess, full = _sharded_stream(
        bsk, hg, batches, nd_batch,
        EngineConfig(**base, partitioner="contiguous", exchange="full"), p3,
        smi)
    _shard_kernel_checks(bsk, ops, sess.runtime.dg.mats[0],
                         sess.runtime.n_pad, smi)
    sess.close()
    torch.cuda.empty_cache()
    # -- the delta exchange (the session's capacity, 1024): bit-equal ------
    sess, delta = _sharded_stream(
        bsk, hg, batches, nd_batch,
        EngineConfig(**base, partitioner="contiguous", exchange="delta"), p3,
        smi)
    sess.close()
    torch.cuda.empty_cache()
    same = all(np.array_equal(a, b)
               for a, b in zip(full["ranks"], delta["ranks"]))
    print(f"delta vs full: ranks bit-equal after every batch: {same}; "
          f"sweeps {delta['sweeps']} vs {full['sweeps']}; exchanges "
          f"full/delta {delta['x'][0]}/{delta['x'][1]} (the full run "
          f"{full['x'][0]}/{full['x'][1]})", flush=True)
    _check(same and delta["sweeps"] == full["sweeps"],
           "the delta exchange's ranks or sweeps differ from the full's")
    _runtime_delta(hg, batches, p3, smi)
    torch.cuda.empty_cache()
    # -- bf16: the CPU tests' size, then n = 1M on phase 3's final graph ----
    _small_runs(smi)
    cfg = EngineConfig(topology="sharded", n_shards=N_SHARDS,
                       block_size=BLOCK, dtype=torch.float32, tau=SMALL_TAU,
                       exchange="bf16")
    sess = PageRankSession.from_graph(
        hg_ref, config=cfg, r0=np.full(hg_ref.n, 1.0 / hg_ref.n),
        device="cuda")
    st = sess.recompute("static")
    torch.cuda.synchronize()
    r = sess.ranks[:sess.n].astype(np.float64)
    ref = p3["ref"][:sess.n]
    print(f"sharded bf16 at n = {sess.n} (f32, tau {SMALL_TAU}, static on "
          f"phase 3's final graph): converged {st.stats.converged}, sweeps "
          f"{st.stats.sweeps}, {st.wall_time_s * 1e3:.1f} ms; L1 "
          f"{np.abs(r - ref).sum():.3e}, L_inf {np.abs(r - ref).max():.3e} "
          f"to the oracle [{smi}]", flush=True)
    _check(bool(np.isfinite(r).all()), "bf16 ranks are not finite")
    sess.close()
    torch.cuda.empty_cache()
    # -- the other partitioners: open warm, batch 1 --------------------------
    for part in ("hash", "bfs_blocks"):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sess = PageRankSession.from_graph(
            hg, config=EngineConfig(**base, partitioner=part),
            r0=p3["r_open"][:hg.n], device="cuda")
        t_open = time.perf_counter() - t0
        mem = _mem_gb(mem0)
        res = sess.update(*batches[0], variant="df")
        torch.cuda.synchronize()
        err = _linf(sess.ranks, full["ranks"][0], sess.n)
        tiles = [m.n_tiles() for m in sess.runtime.dg.mats]
        print(f"sharded {part}: partition {sess._partition_s:.2f} s, open "
              f"{t_open:.2f} s; edge_cut {sess.report().edge_cut:.6f}; live "
              f"tiles per shard {min(tiles)}-{max(tiles)}; card memory "
              f"{mem:.3f} GB; df update 0 {res.wall_time_s * 1e3:.2f} ms, "
              f"sweeps {res.stats.sweeps}; L_inf {err:.3e} to the contiguous "
              f"run's [{smi}]", flush=True)
        _check(res.converged and err <= 1e-8,
               f"sharded {part}: {err} off the contiguous run")
        sess.close()
        torch.cuda.empty_cache()
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    print(f"launches on the sharded path: {launches}; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    _check(launches["block_spmv"] > 0, "the sharded path launched no "
           "block_spmv")
    return launches, full


# ---------------------------------------------------------------------------
# phase 16: the sharded fault path on the main path's graph
# ---------------------------------------------------------------------------

FAULT_BATCH = 2                  # shard 3 lost after 2 sweeps of batch 3
FAULT_SHARD, FAULT_SWEEP = 3, 2
STALL_BATCH, STALE_BATCH = 5, 6  # shard 2 stalls; a stale ShardFault(7)


def _faulted_stream(bsk, hg, batches, base: dict, p3: dict, full: dict,
                    smi: str) -> None:
    """Phase 3's 8 df batches through an 8-shard session opened from phase
    3's opening ranks, with a permanent loss, a stall and a stale fault;
    every batch held to phase 15's unfaulted ranks after it."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.fault_domain import ShardFault
    torch.cuda.synchronize()
    mem_base = torch.cuda.memory_allocated()
    sess = PageRankSession.from_graph(
        hg, config=EngineConfig(**base), r0=p3["r_open"][:hg.n],
        device="cuda")
    sess.warmup()
    for i, (dels, ins) in enumerate(batches):
        if i == FAULT_BATCH:
            sess.inject_shard_fault(FAULT_SHARD, at_sweep=FAULT_SWEEP,
                                    permanent=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        elif i == STALL_BATCH:
            sess.inject_shard_fault(2, at_sweep=FAULT_SWEEP, permanent=False)
        elif i == STALE_BATCH:
            # the race a shrink leaves: shard 7 no longer exists
            sess._shard_faults._pending.append(ShardFault(7))
        recs0 = sess.report().recoveries
        launched0 = bsk.block_spmv_cuda.launches
        builds0 = sess.runtime.cache_size()
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        launched = bsk.block_spmv_cuda.launches - launched0
        # driver_retraces is 0 on a consumed fault by the reference's rule,
        # so the builds are read around the batch itself
        builds = sess.runtime.cache_size() - builds0
        rep = sess.report()
        err = _linf(sess.ranks, full["ranks"][i], sess.n)
        line = (f"shard fault df update {i}: {res.wall_time_s * 1e3:.2f} ms,"
                f" sweeps {res.stats.sweeps} (unfaulted: "
                f"{full['sweeps'][i]}), host syncs {res.host_syncs}, kernel "
                f"#1 launches {launched}, shards {rep.n_shards}; L_inf "
                f"{err:.3e} to phase 15's")
        _check(res.converged and err <= 1e-8,
               f"shard fault df update {i} is {err} off phase 15's")
        _check(res.driver_retraces == 0 and builds == 0,
               f"shard fault df update {i} built {builds} kernel(s)")
        if i == FAULT_BATCH:
            peak = torch.cuda.max_memory_allocated() - mem_base
            ev = rep.recovery_events[-1]
            rec = ev["recovery_sweeps"]
            line += (f"; recovery: {FAULT_SWEEP} sweeps on 8 shards, then "
                     f"{rec} on {rep.n_shards} ({ev['description']}), "
                     f"{ev['helped_vertices']} helped vertices, "
                     f"{ev['wall_time_s']:.3f} s (the shrink and the "
                     f"recovery drive, {launched - 2 * N_SHARDS * FAULT_SWEEP}"
                     f" kernel #1 launches); the session's card peak "
                     f"across the shrink {peak / 1e9:.3f} GB (it held "
                     f"{(mem0 - mem_base) / 1e9:.3f} GB before it)")
            _check(rep.recoveries == recs0 + 1 and ev["domain"] == "shard"
                   and ev["permanent"] and rep.n_shards == N_SHARDS - 1,
                   f"the loss of shard {FAULT_SHARD} recorded {ev}, "
                   f"{rep.n_shards} shards")
            _check(ev["helped_vertices"] > 0 and rec > 0,
                   f"no shard helping: {ev}")
            _check(res.stats.sweeps == FAULT_SWEEP + rec
                   and res.host_syncs == res.stats.sweeps + 1
                   and launched == 2 * (N_SHARDS * FAULT_SWEEP
                                        + (N_SHARDS - 1) * rec),
                   f"the faulted batch: {res.stats.sweeps} sweeps, "
                   f"{res.host_syncs} syncs, {launched} kernel #1 launches")
        elif i == STALL_BATCH:
            ev = rep.recovery_events[-1]
            line += (f"; stall of shard 2: {ev['helped_vertices']} helped, "
                     f"{ev['recovery_sweeps']} recovery sweeps, "
                     f"{ev['wall_time_s']:.3f} s")
            _check(rep.recoveries == recs0 + 1 and not ev["permanent"]
                   and rep.n_shards == N_SHARDS - 1,
                   f"the stall of shard 2 recorded {ev}, {rep.n_shards} "
                   "shards")
        else:
            _check(rep.recoveries == recs0,
                   f"df update {i} recorded a recovery (stale fault?)")
        print(line + f" [{smi}]", flush=True)
    err = _linf(sess.ranks, p3["r_df"], sess.n)
    print(f"shard fault stream: L_inf {err:.3e} to phase 3's ranks after "
          f"its 8 df batches; {sess.report().recoveries} recoveries "
          f"[{smi}]", flush=True)
    _check(err <= 1e-8, f"the faulted stream ends {err} off phase 3's")
    sess.close()


def _durable_sharded(hg, batches, base: dict, p3: dict, full: dict,
                     smi: str) -> None:
    """A durable 8-shard session, dropped after 4 batches, restored onto 8
    and 4 shards and onto one device."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as store:
        sess = PageRankSession.from_graph(
            hg, config=EngineConfig(**base, durability="wal",
                                    checkpoint_interval=3),
            r0=p3["r_open"][:hg.n], device="cuda", store_dir=store)
        sess.warmup()
        walls = []
        for dels, ins in batches[:4]:
            res = sess.update(dels, ins, variant="df")
            torch.cuda.synchronize()
            _check(res.converged, "a durable sharded update did not "
                   "converge")
            walls.append(res.wall_time_s * 1e3)
        live = sess.ranks
        _check(sess.store.latest_checkpoint_index == 3,
               "the durable sharded session did not checkpoint at batch 3")
        print(f"durable sharded df updates 0-3: "
              f"{', '.join(f'{w:.2f}' for w in walls)} ms (batch 3 with "
              f"its checkpoint), p50 {np.percentile(walls, 50):.2f} ms "
              f"beside phase 15's df p50 "
              f"{np.percentile(full['walls'], 50):.2f} ms [{smi}]",
              flush=True)
        del sess, res                  # crash-stop: no close()
        torch.cuda.empty_cache()
        for name, cfg, tol in (
                ("8 shards", None, 1e-12),
                ("4 shards", EngineConfig(**dict(base, n_shards=4)), 1e-8),
                ("one device (pallas)",
                 EngineConfig(engine="pallas", block_size=BLOCK,
                              dtype=torch.float64, tau=TAU), 1e-8)):
            t0 = time.perf_counter()
            rest = PageRankSession.restore(store, config=cfg,
                                           device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rep = rest.report()
            err = _linf(rest.ranks, live, rest.n)
            same = bool(np.array_equal(rest.ranks[:rest.n], live[:rest.n]))
            print(f"sharded restore onto {name}: {wall:.3f} s wall, "
                  f"recovery_time_s {rep.recovery_time_s:.3f}, replayed "
                  f"{rep.replayed_batches}; L_inf {err:.3e} to the live "
                  f"ranks, bit for bit: {same} [{smi}]", flush=True)
            _check(rep.replayed_batches == 1 and err <= tol,
                   f"the restore onto {name}: {rep.replayed_batches} "
                   f"replayed, {err} off the live ranks")
            rest.close()
            del rest
            torch.cuda.empty_cache()


def _sharded_integrity(hg, batches, base: dict, p3: dict, smi: str) -> None:
    """``integrity=`` on an 8-shard session: a clean verify runs the 4
    rank invariants; a stream-state corruption is refused."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.integrity import IntegrityConfig
    sess = PageRankSession.from_graph(
        hg, config=EngineConfig(**base, integrity=IntegrityConfig(
            mass_tol=hg.n * TAU)), r0=p3["r_open"][:hg.n], device="cuda")
    res = sess.update(*batches[0], variant="df")
    rep = sess.verify()
    try:
        sess.inject_corruption("tile")
        refused = "accepted"
    except ValueError as e:
        refused = f"ValueError ({e})"
    print(f"sharded integrity: df update {res.wall_time_s * 1e3:.2f} ms; "
          f"verify ok {rep.ok}, checks_run {rep.checks_run}, "
          f"{rep.wall_time_s * 1e3:.1f} ms, mass error {rep.mass_error:.3e};"
          f" inject_corruption('tile'): {refused[:90]} [{smi}]", flush=True)
    _check(res.converged and rep.ok and rep.checks_run == 4,
           f"the sharded verify: {rep}")
    _check(refused.startswith("ValueError"),
           "a tile corruption was accepted on a sharded session")
    sess.close()


def _shard_fault_phase(bsk, hg, batches, p3: dict, full: dict,
                       smi: str) -> dict:
    """Phase 16 in phase 15's setting, launch counters zeroed just before
    and read at the end.  Returns the launches."""
    t_phase = time.perf_counter()
    base = dict(topology="sharded", n_shards=N_SHARDS, block_size=BLOCK,
                dtype=torch.float64, tau=TAU, partitioner="contiguous",
                exchange="full")
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    _faulted_stream(bsk, hg, batches, base, p3, full, smi)
    torch.cuda.empty_cache()
    _durable_sharded(hg, batches, base, p3, full, smi)
    torch.cuda.empty_cache()
    _sharded_integrity(hg, batches, base, p3, smi)
    torch.cuda.empty_cache()
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    print(f"launches on the sharded fault path: {launches}; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s [{smi}]", flush=True)
    _check(launches["block_spmv"] > 0, "the sharded fault path launched no "
           "block_spmv")
    return launches


# ---------------------------------------------------------------------------
# phase 17: the GNN model zoo and the DF-incremental GNN update
# ---------------------------------------------------------------------------

GNN_SEED = 17
GNN_REPS = 5                     # forwards timed, the median printed
SAGE_MINIBATCHES = 5             # (a): minibatch_lg, sampled
DF_GNN_BATCHES = 3               # (b): ogb_products, rewired in place
DF_GNN_EDGES = 6_186             # 1e-4 of ogb_products' 61,859,140 edges
DF_GNN_TAU_F = 1e-3
DF_GNN_TOL = (1e-5, 1e-6)        # τ_f = 0 update vs a full recompute
# the card (f32) against the same function on the CPU: (rtol, atol); the
# CPU runs in f64 cast back for (a) and (c), in f32 for (b).  EGNN needs
# atol 1e-4: at full_graph_sm its card output was 4.86e-5 and 4.62e-5 off
# the CPU's (1.58x the allowance of rtol 1e-4, atol 1e-5 in one run), the
# positions feeding dist² amplify the card's unordered scatter order
GNN_TOLS = {"graphsage": (1e-4, 1e-5), "gatedgcn": (1e-4, 1e-5),
            "egnn": (1e-4, 1e-4), "meshgraphnet": (1e-4, 1e-5)}
# the aten op that launched a kernel → its part of a forward's device time
GNN_OPS = {"gather": {"aten::index_select", "aten::index", "aten::gather",
                      "aten::take", "aten::embedding"},
           "scatter": {"aten::index_add_", "aten::index_add",
                       "aten::scatter_reduce_", "aten::scatter_reduce",
                       "aten::scatter_add_", "aten::index_put_",
                       "aten::_index_put_impl_"},
           "matmul": {"aten::mm", "aten::addmm", "aten::bmm",
                      "aten::matmul", "aten::linear", "aten::baddbmm"}}
GNN_DEVICE_COVER = 0.8    # a device-bound call's kernels, least share of wall
GNN_TRACES = 3            # profiled calls at most, until two in a row agree


def _gnn_trace(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler``: its kernels' device time
    split by the aten op that launched each (self device time of every op),
    and the sum over all kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(("gather", "scatter", "matmul", "other"), 0.0)
    kernels = 0.0
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type == DeviceType.CUDA:
            kernels += ms
        elif ms:
            kind = next((k for k, ops in GNN_OPS.items() if e.key in ops),
                        "other")
            split[kind] += ms
    return split, kernels


def _gnn_split(fn, wall_ms: float, device_bound: bool = False) -> str:
    """The device split of ``fn`` beside its share of ``wall_ms``, the
    call's CUDA-event time.  The profiler can miss kernels, so traces are
    taken until two in a row agree within 10 % on the kernel sum (at most
    ``GNN_TRACES``), and a ``device_bound`` call's kernels must also cover
    ``GNN_DEVICE_COVER`` of the wall (a launch-bound call's rightly cover
    less).  The last trace is printed, marked partial where it fell short."""
    prev = None
    for _ in range(GNN_TRACES):
        split, kernels = _gnn_trace(fn)
        cover = kernels / wall_ms
        agree = prev is not None and abs(kernels - prev) <= 0.1 * kernels
        partial = not agree or (device_bound and cover < GNN_DEVICE_COVER)
        if kernels > 0 and not partial:
            break
        prev = kernels
    if kernels == 0:
        return "device split not measured (the profiler recorded no " \
               "device time)"
    return (("device split partial " if partial else "device split ")
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" ms of {kernels:.3f} ms of kernels ({cover:.0%} of the "
            f"{wall_ms:.3f} ms wall)")


def _to(x, device, dtype=None):
    """A tensor, or each tensor of a GraphBatch / list, on ``device``; float
    tensors cast to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        t = x.to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    if isinstance(x, (list, tuple)) and not hasattr(x, "_replace"):
        return [_to(v, device, dtype) for v in x]
    if isinstance(x, dict):
        return {k: _to(v, device, dtype) for k, v in x.items()}
    return x._replace(**{f: _to(getattr(x, f), device, dtype)
                         for f in x._fields
                         if isinstance(getattr(x, f), torch.Tensor)})


def _gnn_hold(what: str, got, ref, tol: tuple) -> str:
    """Hold the card's ``got`` to the CPU's ``ref`` at ``tol`` (rtol, atol);
    returns the measured error for the line."""
    rtol, atol = tol
    a = got.detach().double()
    b = ref.detach().to(a.device).double()
    _check(a.shape == b.shape and bool(torch.isfinite(a).all()),
           f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)} or not "
           "finite")
    d = (a - b).abs()
    # the share of its allowance the worst element uses (allclose: <= 1)
    use = float((d / (atol + rtol * b.abs())).max())
    err, top = float(d.max()), float(b.abs().max())
    _check(use <= 1, f"{what}: card vs CPU max abs err {err:.3e} (|ref| up "
           f"to {top:.3g}), {use:.2f}x its allowance at rtol {rtol}, atol "
           f"{atol}")
    return (f"{what} max abs err {err:.3e} of |ref| {top:.3g} ({use:.2f} "
            "of tol)")


def _gnn_family(name: str, mod, cfg, g, labels, smi: str) -> None:
    """(c): one family's forward and loss on the card at its full config,
    held to the same functions on the CPU in f64, timed and split."""
    params = mod.init(cfg, GNN_SEED, device="cpu")
    p_d, g_d, y_d = _to(params, "cuda"), _to(g, "cuda"), _to(labels, "cuda")
    p_c, g_c = _to(params, "cpu", torch.float64), _to(g, "cpu",
                                                      torch.float64)
    y_c = labels.double() if labels.is_floating_point() else labels

    def fwd():
        return mod.forward(p_d, cfg, g_d)

    out, ref = fwd(), mod.forward(p_c, cfg, g_c)
    ref32 = mod.forward(params, cfg, g)     # the CPU's own f32 error
    loss, _ = mod.loss_fn(p_d, cfg, g_d, y_d)
    ref_loss, _ = mod.loss_fn(p_c, cfg, g_c, y_c)
    tol = GNN_TOLS[cfg.family]
    if cfg.family == "egnn":
        errs = [_gnn_hold("out", out[0], ref[0], tol),
                _gnn_hold("pos", out[1], ref[1], tol)]
        ref, ref32 = ref[0], ref32[0]
    else:
        errs = [_gnn_hold("out", out, ref, tol)]
    errs.append(_gnn_hold("loss", loss, ref_loss, tol))
    errs.append(f"the CPU's f32 out {float((ref32 - ref).abs().max()):.3e} "
                "off its f64")
    ms = _event_ms(fwd, reps=GNN_REPS)
    print(f"gnn {name}: {cfg.n_layers}x{cfg.d_hidden}, n {g.n_pad}, e "
          f"{g.senders.shape[0]}: forward {ms:.3f} ms (median of "
          f"{GNN_REPS}), {_gnn_split(fwd, ms)}; card vs CPU f64: "
          f"{'; '.join(errs)} (rtol {tol[0]}, atol {tol[1]}) [{smi}]",
          flush=True)


def _gnn_families(smi: str) -> None:
    """(c): every family at full_graph_sm, and egnn at molecule."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import gnn_full_graph_batch
    from repro_torch.models.gnn import GraphBatch, get_family
    dims = get_arch("gatedgcn").shape("full_graph_sm").dims
    data = gnn_full_graph_batch(n=dims["n_nodes"], e=dims["n_edges"],
                                d_feat=dims["d_feat"], n_out=dims["n_out"],
                                seed=GNN_SEED, with_pos=True, device="cpu")
    for arch in ("graphsage-reddit", "gatedgcn", "egnn", "meshgraphnet"):
        cfg = get_arch(arch).build_cfg(d_feat=dims["d_feat"],
                                       n_out=dims["n_out"], task="node_clf")
        pos = data["pos"] if cfg.family in ("egnn", "meshgraphnet") else None
        g = GraphBatch(nodes=data["nodes"], senders=data["senders"],
                       receivers=data["receivers"], pos=pos)
        _gnn_family(f"{arch} full_graph_sm", get_family(cfg), cfg, g,
                    data["labels"], smi)
    # molecule: 128 graphs of 30 nodes and 64 edges, batched with offsets
    dims = get_arch("egnn").shape("molecule").dims
    nb, nn, ne = dims["batch"], dims["n_nodes"], dims["n_edges"]
    rng = np.random.default_rng(GNN_SEED)
    off = (np.arange(nb) * nn)[:, None]
    g = GraphBatch(
        nodes=torch.from_numpy(
            rng.normal(size=(nb * nn, dims["d_feat"])).astype(np.float32)),
        senders=torch.from_numpy(
            (rng.integers(0, nn, (nb, ne)) + off).reshape(-1)),
        receivers=torch.from_numpy(
            (rng.integers(0, nn, (nb, ne)) + off).reshape(-1)),
        pos=torch.from_numpy(rng.normal(size=(nb * nn, 3)).astype(np.float32)),
        graph_id=torch.from_numpy(np.repeat(np.arange(nb), nn)),
        n_graphs=nb)
    labels = torch.from_numpy(
        rng.normal(size=(nb, dims["n_out"])).astype(np.float32))
    cfg = get_arch("egnn").build_cfg(d_feat=dims["d_feat"],
                                     n_out=dims["n_out"], task="graph_reg")
    _gnn_family("egnn molecule", get_family(cfg), cfg, g, labels, smi)


def _sage_sampled(smi: str) -> None:
    """(a): GraphSAGE at minibatch_lg, its sampler over the shape's whole
    graph, 5 minibatches through the data pipeline."""
    from repro_torch.configs import get_arch, graphsage_reddit
    from repro_torch.data.pipeline import (gnn_full_graph_batch,
                                           graphsage_minibatch_stream)
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models.gnn import graphsage
    dims = get_arch("graphsage-reddit").shape("minibatch_lg").dims
    cfg = graphsage_reddit.build_cfg(d_feat=dims["d_feat"],
                                     n_out=dims["n_out"])
    fanouts = (dims["fanout1"], dims["fanout2"])
    t0 = time.perf_counter()
    data = gnn_full_graph_batch(n=dims["n_nodes"], e=dims["n_edges"],
                                d_feat=dims["d_feat"], n_out=dims["n_out"],
                                seed=GNN_SEED, device="cpu")
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(dims["n_nodes"], data["senders"].numpy(),
                              data["receivers"].numpy())
    t_csr = time.perf_counter() - t0
    print(f"graphsage minibatch_lg: graph n {dims['n_nodes']}, m "
          f"{dims['n_edges']} made in {t_gen:.1f} s, sampler CSR in "
          f"{t_csr:.1f} s [{smi}]", flush=True)
    feats, labels = data["nodes"].numpy(), data["labels"].numpy()
    del data
    params = graphsage.init(cfg, GNN_SEED, device="cpu")
    p_d, p_c = _to(params, "cuda"), _to(params, "cpu", torch.float64)
    stream = graphsage_minibatch_stream(
        sampler, feats, labels, batch_nodes=dims["batch_nodes"],
        fanouts=fanouts, seed=GNN_SEED, device="cuda")
    tol = GNN_TOLS["graphsage"]
    host_s, errs = [], []
    for i in range(SAGE_MINIBATCHES):
        t0 = time.perf_counter()
        batch = next(stream)
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
        hops = [batch[f"hop{k}"] for k in range(cfg.n_layers + 1)]
        _check(tuple(hops[-1].shape) == (dims["batch_nodes"],) + fanouts
               + (dims["d_feat"],), f"hop tensor {tuple(hops[-1].shape)}")
        logits = graphsage.forward_sampled(p_d, cfg, hops)
        loss, _ = graphsage.loss_fn_sampled(p_d, cfg, hops, batch["labels"])
        hops_c = _to(hops, "cpu", torch.float64)
        ref = graphsage.forward_sampled(p_c, cfg, hops_c)
        ref_loss, _ = graphsage.loss_fn_sampled(p_c, cfg, hops_c,
                                                batch["labels"].cpu())
        errs.append(_gnn_hold(f"minibatch {i} logits", logits, ref, tol)
                    + "; " + _gnn_hold("loss", loss, ref_loss, tol))

    def fwd():
        return graphsage.forward_sampled(p_d, cfg, hops)

    ms = _event_ms(fwd, reps=GNN_REPS)
    print(f"graphsage minibatch_lg sampled: {SAGE_MINIBATCHES} minibatches "
          f"of {dims['batch_nodes']} seeds, fanouts {fanouts}, hop-2 "
          f"{tuple(hops[-1].shape)} f32 ({hops[-1].nbytes / 1e6:.1f} MB); "
          f"host sample + gather + upload {np.median(host_s) * 1e3:.1f} ms "
          f"(median); forward_sampled {ms:.3f} ms (median of {GNN_REPS}), "
          f"{_gnn_split(fwd, ms)} [{smi}]", flush=True)
    print(f"graphsage minibatch_lg, card vs CPU f64 (rtol {tol[0]}, atol "
          f"{tol[1]}): {' | '.join(errs)} [{smi}]", flush=True)


def _df_gnn(smi: str) -> None:
    """(b): the DF-incremental GraphSAGE update at ogb_products, full
    batch: one full pass, then 3 batches rewired in place."""
    from repro_torch.configs import get_arch, graphsage_reddit
    from repro_torch.core.incremental import (edge_update_sources,
                                              full_gnn_layers,
                                              incremental_gnn_update)
    from repro_torch.data.pipeline import gnn_full_graph_batch
    from repro_torch.models.gnn import GraphBatch, graphsage
    dims = get_arch("graphsage-reddit").shape("ogb_products").dims
    n, e = dims["n_nodes"], dims["n_edges"]
    cfg = graphsage_reddit.build_cfg(d_feat=dims["d_feat"],
                                     n_out=dims["n_out"])
    data = gnn_full_graph_batch(n=n, e=e, d_feat=dims["d_feat"],
                                n_out=dims["n_out"], seed=GNN_SEED + 1,
                                device="cpu")
    params = graphsage.init(cfg, GNN_SEED, device="cpu")
    fns_c = full_gnn_layers(graphsage, params, cfg)
    fns_d = full_gnn_layers(graphsage, _to(params, "cuda"), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    g_c = GraphBatch(nodes=data["nodes"], senders=data["senders"],
                     receivers=data["receivers"])
    g_d = _to(g_c, "cuda")
    snd_h, rcv_h = g_c.senders.numpy(), g_c.receivers.numpy()  # g_c's own

    def full_pass(g, fns):
        cache = [g.nodes]
        for fn in fns:
            cache.append(fn(g, cache[-1]))
        return cache

    cache = full_pass(g_d, fns_d)
    ms_full = _event_ms(lambda: full_pass(g_d, fns_d), reps=3)
    print(f"graphsage ogb_products full pass: n {n}, e {e}, "
          f"{cfg.n_layers}x{cfg.d_hidden}: {ms_full:.3f} ms (median of 3), "
          f"{_gnn_split(lambda: full_pass(g_d, fns_d), ms_full, True)} "
          f"[{smi}]", flush=True)
    tol = GNN_TOLS["graphsage"]
    rng = np.random.default_rng(GNN_SEED)
    for b in range(DF_GNN_BATCHES):
        # rewire k edges in place, as tests/test_ckpt_and_substrate.py does;
        # the card takes the host's final values (a repeated index too)
        idx = rng.integers(0, e, DF_GNN_EDGES)
        old = np.stack([snd_h[idx], rcv_h[idx]], 1)
        snd_h[idx] = rng.integers(0, n, DF_GNN_EDGES)
        rcv_h[idx] = rng.integers(0, n, DF_GNN_EDGES)
        new = np.stack([snd_h[idx], rcv_h[idx]], 1)
        it = torch.from_numpy(idx).cuda()
        g_d.senders[it] = torch.from_numpy(snd_h[idx]).cuda()
        g_d.receivers[it] = torch.from_numpy(rcv_h[idx]).cuda()
        sources = edge_update_sources(n, old, new, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _, st = incremental_gnn_update(fns_d, g_d, g_d.nodes, cache,
                                          sources, tau_f=DF_GNN_TAU_F)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _, cache0, st0 = incremental_gnn_update(fns_d, g_d, g_d.nodes, cache,
                                                sources, tau_f=0.0)
        full = full_pass(g_d, fns_d)
        for i in (1, 2):
            a, c = cache0[i], full[i]
            _check(bool(torch.allclose(a, c, rtol=DF_GNN_TOL[0],
                                       atol=DF_GNN_TOL[1])),
                   f"df gnn batch {b}: the τ_f = 0 update's layer {i} is "
                   f"{float((a - c).abs().max()):.3e} off a full recompute")
        err0 = float((cache0[-1] - full[-1]).abs().max())
        dev_tau = float((h - full[-1]).abs().max())
        _check(st["recomputed"] < st["total"] and st0["recomputed"]
               < st0["total"], f"df gnn batch {b}: the frontier did not "
               f"prune: {st}, {st0}")
        line = ""
        if b == 0:
            # the full recompute on the CPU (g_c holds the rewired graph):
            # the card's full recompute and its τ_f = 0 update held to it
            t1 = time.perf_counter()
            full_c = full_pass(g_c, fns_c)
            errs = [_gnn_hold(f"{what} layer {i}", got[i], full_c[i], tol)
                    for what, got in (("full", full), ("τ_f 0 update",
                                                       cache0))
                    for i in (1, 2)]
            t_full = time.perf_counter() - t1
            del full_c
            # the τ_f update on the CPU from the same inputs: the card's
            # pre-batch cache, the rewired graph, the batch's sources
            t1 = time.perf_counter()
            h_c, _, st_c = incremental_gnn_update(
                fns_c, g_c, g_c.nodes, _to(cache, "cpu"),
                edge_update_sources(n, old, new, device="cpu"),
                tau_f=DF_GNN_TAU_F)
            errs.append(_gnn_hold(f"τ_f {DF_GNN_TAU_F} update", h, h_c, tol))
            _check(st == st_c, f"df gnn batch {b}: the τ_f {DF_GNN_TAU_F} "
                   f"update's stats {st} on the card, {st_c} on the CPU")
            line = (f"; CPU f32 full recompute {t_full:.1f} s, τ_f "
                    f"{DF_GNN_TAU_F} update {time.perf_counter() - t1:.1f} s "
                    f"(its stats equal the card's); card vs CPU: "
                    f"{'; '.join(errs)}")
            del h_c
        if b == 1:
            split = _gnn_split(lambda: incremental_gnn_update(
                fns_d, g_d, g_d.nodes, cache, sources, tau_f=DF_GNN_TAU_F),
                wall_ms, True)
            line = f"; {split}"
        fr = [f"{a / n:.4f}" for a in st["affected"]]
        print(f"df gnn batch {b}: {DF_GNN_EDGES} edges rewired, update "
              f"{wall_ms:.1f} ms wall at τ_f {DF_GNN_TAU_F}, affected "
              f"fraction per layer {fr} (recomputed {st['recomputed']} of "
              f"{st['total']}; τ_f 0: {st0['affected']}), max |h − full| "
              f"{dev_tau:.3e}, τ_f = 0 update vs full recompute "
              f"{err0:.3e}{line} [{smi}]", flush=True)
        cache = full          # the exact cache, so each τ_f = 0 check holds
        del full, cache0, h
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    print(f"df gnn ogb_products: peak card memory {peak:.2f} GB above the "
          f"phase's start [{smi}]", flush=True)


def _gnn_phase(kernel_fns, smi: str) -> None:
    """Phase 17: (a) GraphSAGE sampled at minibatch_lg, (b) the
    DF-incremental GraphSAGE update at ogb_products, (c) every family at
    full_graph_sm and egnn at molecule.  No hand-written kernel is on this
    path: the counters are zeroed before and must read 0 after."""
    t_phase = time.perf_counter()
    _check(torch.backends.cuda.matmul.allow_tf32 is False,
           "TF32 is on: the GNN products must stay IEEE f32")
    for fn in kernel_fns:
        fn.launches = 0
    parts = {}
    for part, fn in (("(c) families", _gnn_families),
                     ("(a) sampled", _sage_sampled),
                     ("(b) df-incremental", _df_gnn)):
        t0 = time.perf_counter()
        fn(smi)
        torch.cuda.empty_cache()
        parts[part] = round(time.perf_counter() - t0, 1)
    launches = {fn.__name__: fn.launches for fn in kernel_fns}
    print(f"launches on the GNN path: {launches} (message passing is "
          f"index_select / index_add_, the products torch.matmul); phase 17 "
          f"took {time.perf_counter() - t_phase:.1f} s ({parts} s, torch "
          f"threads {torch.get_num_threads()}) [{smi}]", flush=True)
    _check(not any(launches.values()), "the GNN path launched a PageRank "
           "kernel")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device is visible; the port's smoke run needs one")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        _fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
              "checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core import pallas_engine as pe
    from repro_torch.core.delta import random_batch
    from repro_torch.core.pagerank import numpy_reference
    from repro_torch.graphs.generators import grid_road
    from repro_torch.kernels.block_spmv import block_spmv as bsk
    from repro_torch.kernels.block_spmv import ops
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws
    from repro_torch.kernels.walk import walk as wk

    t_start = time.perf_counter()
    # -- phase 1: device and build -----------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:   # one nvcc each
        list(pool.map(lambda lib: lib(), (bsk.library, bws.library,
                                          wk.library)))
    print(f"kernel builds + loads (block_spmv, blocked_sweep, walk, in "
          f"parallel): {time.perf_counter() - t0:.2f} s", flush=True)

    # -- phase 2: kernel parity ---------------------------------------------
    rng = np.random.default_rng(2024)
    _parity(bsk, ops, rng)
    _packed_cases(bsk, ops, rng)
    _poisoned_drive_matches(bsk, pe)

    # -- phase 3: main path --------------------------------------------------
    t0 = time.perf_counter()
    hg = grid_road(SIDE, seed=7)
    print(f"graph: grid_road({SIDE}) n={hg.n} m={hg.m} (+{hg.n} self-loops)"
          f" in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = EngineConfig(block_size=BLOCK, dtype=torch.float64, tau=TAU)
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    r_open = sess.ranks                   # phase 10's warm start
    cold = (bsk.block_spmv_cuda.launches, bsk.block_spmv_active_cuda.launches)
    mat = sess.inc.mat
    print(f"open + cold solve: {t_open:.2f} s; tile pool {mat.n_tiles()} "
          f"live tiles, capacity {mat.tile_capacity} "
          f"({mat.tiles.nbytes / 1e9:.2f} GB), max_tiles {mat.max_tiles}, "
          f"packed index {mat.index.nbytes / 1e6:.2f} MB "
          f"({mat.index.tail} entries of {mat.index.entry_capacity}); "
          f"launches (block_spmv, block_spmv_active) = {cold}", flush=True)
    sess.warmup()
    mem3 = torch.cuda.memory_allocated() - mem0     # for phase 10
    df, growth, batches, kept = [], [], [], {}
    for i in range(N_DF_UPDATES):
        dels, ins = random_batch(sess.hg, 1e-4, seed=100 + i,
                                 deletions_frac=0.2)
        batches.append((dels, ins))
        idx = sess.inc.mat.index            # refreshed in place
        tail0, e_cap0 = idx.tail, idx.entry_capacity
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        idx = sess.inc.mat.index
        if idx.entry_capacity == e_cap0 and idx.tail > tail0:
            growth.append(idx.tail - tail0)         # not a compaction
        df.append(res)
        kept[i + 1] = sess.ranks            # for phases 9 and 15
        print(f"df update {i}: {len(dels)} del + {len(ins)} ins, "
              f"{res.wall_time_s * 1e3:.2f} ms, sweeps {res.stats.sweeps}, "
              f"blocks {res.stats.blocks_processed}, edges "
              f"{res.stats.edges_processed}, host syncs {res.host_syncs}, "
              f"converged {res.converged}", flush=True)
    after_df = (bsk.block_spmv_cuda.launches,
                bsk.block_spmv_active_cuda.launches)
    dels, ins = random_batch(sess.hg, 1e-4, seed=100 + N_DF_UPDATES,
                             deletions_frac=0.2)
    nd_batch = (dels, ins)
    nd = sess.update(dels, ins, variant="nd")
    torch.cuda.synchronize()
    print(f"nd update (baseline): {nd.wall_time_s * 1e3:.2f} ms, sweeps "
          f"{nd.stats.sweeps}, edges {nd.stats.edges_processed}, host syncs "
          f"{nd.host_syncs}", flush=True)
    top_vals, top_ids = sess.top_k(10)
    q = sess.query(top_ids)
    launches = {"block_spmv": bsk.block_spmv_cuda.launches,
                "block_spmv_active": bsk.block_spmv_active_cuda.launches}
    walls = np.array([r.wall_time_s for r in df]) * 1e3
    print(f"df per-update wall: p50 {np.percentile(walls, 50):.2f} ms, p95 "
          f"{np.percentile(walls, 95):.2f} ms over {len(walls)} updates; "
          f"host syncs per drive {[r.host_syncs for r in df]}", flush=True)
    print(f"launches on the main path: {launches} (cold solve {cold}, "
          f"after the df updates {after_df})", flush=True)
    print(f"report: {sess.report()}", flush=True)

    _check(all(r.converged for r in df) and nd.converged,
           "an update did not converge")
    _check(sess.report().retraces_post_warmup == 0,
           "a kernel was built after warmup")
    _check(after_df[1] > cold[1], "df updates launched no block_spmv_active")
    _check(launches["block_spmv"] > after_df[0],
           "the nd update launched no block_spmv")
    _check(cold[0] > 0, "the cold solve launched no block_spmv")
    _check(bool(np.array_equal(q, top_vals)), "query != top_k values")

    t0 = time.perf_counter()
    hg_ref = sess.hg                      # the graph phase 3's oracle is of
    ref = numpy_reference(hg_ref.snapshot(block_size=BLOCK))
    r = sess.ranks
    err = float(np.abs(r[:sess.n] - ref[:sess.n]).max())
    mass = float(r[:sess.n].sum())
    print(f"oracle ({time.perf_counter() - t0:.1f} s): L_inf {err:.3e}, "
          f"|mass - 1| {abs(mass - 1):.3e} (oracle's own "
          f"{abs(ref.sum() - 1):.3e})", flush=True)
    _check(bool(np.isfinite(r).all()) and r.shape == (sess.n_pad,),
           "ranks are not finite or of the wrong shape")
    _check(err <= 1e-9, f"L_inf vs numpy_reference {err} > 1e-9")
    # bound of the repo's integrity check (core/integrity.py): a converged
    # DF iterate's mass error is at most n * tau
    _check(abs(mass - 1) <= sess.n * TAU, f"|mass - 1| = {abs(mass - 1)}")
    _check(bool(np.allclose(top_vals, ref[top_ids], rtol=0, atol=1e-9)),
           "top_k values disagree with the oracle")
    _check(top_vals[-1] >= np.sort(ref[:sess.n])[-10] - 1e-9,
           "top_k missed an oracle top-10 vertex")

    # -- phase 4: kernel timing at the main path's shapes -------------------
    table = _time_kernels(bsk, ops, sess, rng)
    _check(len(growth) > 0, "no df update re-packed at the index's tail")
    _time_compaction(bsk, ops, sess.inc.mat, growth)
    for row in table:
        _print_row(row, smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    _profile_update(sess, random_batch)
    _device_busy(sess, random_batch)
    sess.close()

    # -- phase 6: the push driver, same graph and traffic -------------------
    push_launches, p6 = _push_phase(
        bsk, ops, hg, EngineConfig(block_size=BLOCK, dtype=torch.float64,
                                   tau=TAU, driver="push"),
        batches, df, nd_batch, ref, smi)
    torch.cuda.empty_cache()

    # -- phase 7: the variant matrix, same graph ----------------------------
    var_launches = _variants_phase(bsk, hg, smi)
    torch.cuda.empty_cache()

    # -- phase 8: the blocked engine, on phase 3's final graph --------------
    blk_launches, sweep_row = _blocked_phase(bws, bsk, hg_ref, ref, smi)
    torch.cuda.empty_cache()

    # -- phase 9: durability, on phase 3's graph and batches ----------------
    dur_launches = _durable_phase(bsk, batches, nd_batch, kept, r,
                                  float(np.percentile(walls, 50)), smi)
    torch.cuda.empty_cache()

    # -- phase 10: the tiered pull path, on phase 3's graph and batches -----
    p3 = {"r_open": r_open, "r_df": kept[N_DF_UPDATES], "r_nd": r,
          f"r_{N_CHILD_UPDATES}": kept[N_CHILD_UPDATES],
          "ref": ref, "mem": mem3, "df_ms": walls,
          "syncs": [x.host_syncs for x in df],
          "sweeps": [x.stats.sweeps for x in df],
          "r_batches": [kept[i + 1] for i in range(N_DF_UPDATES)]}
    tier_launches, pool_bytes, tier_ms = _tiered_phase(
        bsk, hg, batches, nd_batch, p3, smi)
    torch.cuda.empty_cache()

    # -- phase 11: the tiered push path, after phase 10's sessions closed ---
    tpush_launches = _tiered_push_phase(bsk, hg, batches, nd_batch,
                                        pool_bytes // 2, p3, p6, smi)
    torch.cuda.empty_cache()

    # -- phase 12: integrity, after phase 11's sessions closed --------------
    integ_launches = _integrity_phase(bsk, hg, batches, nd_batch, p3,
                                      pool_bytes // 2, tier_ms, smi)
    torch.cuda.empty_cache()

    # -- phase 13: serving, after phase 12's sessions closed ----------------
    serve_launches = _serving_phase(bsk, hg, batches, nd_batch, p3, smi)
    torch.cuda.empty_cache()

    # -- phase 14: the walk engine and PPR, same graph and batches ----------
    walk_launches, walk_rows = _walk_phase(bsk, bws, hg, batches, nd_batch,
                                           ref, smi)
    torch.cuda.empty_cache()

    # -- phase 15: the sharded session, same graph and batches --------------
    shard_launches, full = _sharded_phase(bsk, ops, hg, hg_ref, batches,
                                          nd_batch, p3, smi)
    torch.cuda.empty_cache()

    # -- phase 16: the sharded fault path, same graph and batches -----------
    fault_launches = _shard_fault_phase(bsk, hg, batches, p3, full, smi)
    torch.cuda.empty_cache()

    # -- phase 17: the GNN model zoo and the DF-incremental GNN update ------
    _gnn_phase((bsk.block_spmv_cuda, bsk.block_spmv_active_cuda,
                bws.blocked_sweep_cuda, wk.walk_regen_cuda,
                wk.walk_touch_cuda), smi)
    for row in table:
        row["launches"] = sum(
            path[row["name"]] for path in (
                launches, push_launches, var_launches, blk_launches,
                dur_launches, tier_launches, tpush_launches,
                integ_launches, serve_launches, walk_launches,
                shard_launches, fault_launches))
    table.append(sweep_row)
    table.extend(walk_rows)
    print(f"total {time.perf_counter() - t_start:.1f} s [{smi}]", flush=True)
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--durable-child":
        _durable_child(sys.argv[2])
    elif len(sys.argv) == 1:
        main()
    else:
        _fail("usage: python3 chip_smoke.py (the internal child mode is "
              "--durable-child DIR)")
