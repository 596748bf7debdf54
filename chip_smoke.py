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
   time.  Then the sweep kernel against its plain
   version (LF and BB, on the card) over all 16,384 slots of a cold start
   and over the compacted DF frontier of the first batch, timed beside its
   bound;
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
   device-memory delta.

The kernel JSON line's ``launches`` add the pull path's (phase 3), the
push path's (phase 6), the variant matrix's (phase 7), the blocked
path's (phase 8) and the durable path's (phase 9).  Prints the
kernel table as one JSON line, then as its last line
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
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F64_FLOPS = 34e12                # H100 SXM FP64 outside the tensor cores
SIDE = 1024                      # grid_road(1024): n = 1,048,576
BLOCK = 64
TAU = 1e-10
N_DF_UPDATES = 8
N_DT_UPDATES = 2
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
                smi: str) -> dict:
    """The push driver on the same graph and traffic as phase 3; returns
    its launch counts.  Also holds and times the kernel #2 launch at the
    push's shapes, and profiles one more push update."""
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.core.push_engine import residual_from_host
    bsk.block_spmv_cuda.launches = 0
    bsk.block_spmv_active_cuda.launches = 0
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
    return launches


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


def _sweep_parity(bws, blk, g, R0, aff0, ids, mask, *, expand: bool,
                  what: str) -> dict:
    """One LF and one BB sweep through the kernel and through its plain
    version (both on the card) from the same state: affected, RC and the
    per-slot edges array-equal, R and maxdr within 1e-12.  Returns the
    worst error, the LF kernel's per-slot edges, the plain LF sweep's host
    time and the kernel's device time (mean of 3 fresh launches)."""
    sg = blk.sweep_graph(g, R0.dtype)
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
            out["plain_s"] = tp
            times = []
            for _ in range(3):
                R, A, C = _sweep_state(R0, aff0)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                bws.blocked_sweep_cuda(sg, R, R, A, C, ids, mask,
                                       jacobi=False, **kw)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out["ms"] = float(np.mean(times))
    return out


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
        max_abs_err=max(cold_par["err"], df_par["err"]),
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
        list(pool.map(lambda lib: lib(), (bsk.library, bws.library)))
    print(f"kernel builds + loads (block_spmv, blocked_sweep, in parallel): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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
    t0 = time.perf_counter()
    sess = PageRankSession.from_graph(hg, config=cfg, device="cuda")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    cold = (bsk.block_spmv_cuda.launches, bsk.block_spmv_active_cuda.launches)
    mat = sess.inc.mat
    print(f"open + cold solve: {t_open:.2f} s; tile pool {mat.n_tiles()} "
          f"live tiles, capacity {mat.tile_capacity} "
          f"({mat.tiles.nbytes / 1e9:.2f} GB), max_tiles {mat.max_tiles}, "
          f"packed index {mat.index.nbytes / 1e6:.2f} MB "
          f"({mat.index.tail} entries of {mat.index.entry_capacity}); "
          f"launches (block_spmv, block_spmv_active) = {cold}", flush=True)
    sess.warmup()
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
        if i + 1 in (N_CHILD_UPDATES, N_DF_UPDATES):   # for phase 9
            kept[i + 1] = sess.ranks
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
    push_launches = _push_phase(
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
    for row in table:
        row["launches"] = (launches[row["name"]] + push_launches[row["name"]]
                           + var_launches[row["name"]]
                           + blk_launches[row["name"]]
                           + dur_launches[row["name"]])
    table.append(sweep_row)
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
