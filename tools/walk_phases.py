"""Where walk_regen's time goes, phase by phase, on the card; and the walk
kernels' times at chip_smoke.py's phase 14 shapes.

    python3 tools/walk_phases.py [--src DIR] [--reps N]

Opens the walk store of ``chip_smoke.py``'s phase 14 on
``grid_road(1024, seed=7)`` (n = 1,048,576, R = 16, L = 48, seed 0) with
``DIR/src``'s ``repro_torch`` (default: this checkout) and times with CUDA
events, N launches each (3 by default), the kernels as built, each call
queued while a sleep kernel holds the stream so that the wrapper's host
time stays out of the window (as ``chip_smoke.py``'s ``_time_ms`` does):
``walk_regen`` over all 16,777,216 ids from sentinel rows (the open); ``walk_regen`` over
the walks one ``df`` batch flags (the touched sources of
``random_batch(hg, 1e-4, seed=100, deletions_frac=0.2)``, phase 14's first
batch) on the open's adjacency, so that each row is rewritten as it was;
and ``walk_touch`` over that touched set, beside a yardstick kernel
(``HEAD_READ``, built here): a thread a row, 512 a block as ``walk_touch``
has, reads its row's first 16 bytes and writes one byte, the least a
thread-a-row pass over the 192-byte rows pays.  It computes on the host, from
the walks, the divergence share of a thread-a-walk layout (for each 32
consecutive list entries, 32 × the longest walk's drawing steps against the
sum of their drawing steps).  Where the tree's ``walk.cu`` compiles the
``clock64()`` counters in (``-DWALK_PHASES``), it then builds that source
with the macro under a library name of its own, runs both ``walk_regen``
cases through that build, checks that walks, counts and steps equal the
plain build's, and prints for each the cycles a warp spends in each phase
of its loop, the share of lane-cycles with no walk and the share of the
cipher blocks computed (two a lane a pass) that a walk uses.  The counters cost
time themselves, and in a kernel whose warps overlap each other's waits, a
phase's share of a warp's cycles is where the warp waits, not what the
card's throughput pays for it.  Prints, as its last line, one JSON object
with the card's name and power limit and every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
R, L, SEED = 16, 48, 0          # chip_smoke.py's WALK_R, WALK_L, walk seed
PHASES = ("refill", "retire", "start", "cipher", "pick", "atomics", "stores")
HOLD_CYCLES = 20_000_000        # the sleep that holds the stream (>= 10 ms)

HEAD_READ = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(512)
    head_read_kernel(const int4* __restrict__ walks, long long nr, int quads,
                     int n, uint8_t* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (w >= nr) return;
  const int4 u = walks[w * quads];
  out[w] = (u.x ^ u.y ^ u.z ^ u.w) == n;
}

extern "C" int head_read(const void* walks, long long nr, int L, int n,
                         void* out) {
  head_read_kernel<<<static_cast<unsigned>((nr + 511) / 512), 512>>>(
      static_cast<const int4*>(walks), nr, L / 4, n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def divergence(live: torch.Tensor, L: int) -> dict:
    """The thread-a-walk layout's lane-steps: each 32 consecutive list
    entries run for the longest one's drawing steps (min(l, L - 1) for l
    live entries)."""
    s = live.clamp(max=L - 1).long()
    pad = (-s.numel()) % 32
    g = torch.cat([s, s.new_zeros(pad)]).view(-1, 32)
    issued = int(g.max(1).values.sum()) * 32
    used = int(s.sum())
    return {"lane_steps_issued": issued, "lane_steps_used": used,
            "issued_over_used": issued / max(used, 1),
            "divergence_share": 1.0 - used / max(issued, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="the tree whose src/repro_torch is measured")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed launches of each kernel")
    args = ap.parse_args()
    reps = args.reps
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    tree = args.src.resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.delta import random_batch
    from repro_torch.core.walk_engine import WalkState
    from repro_torch.graphs.generators import grid_road
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.walk import walk as wk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    hg = grid_road(1024, seed=7)
    ws = WalkState(hg, R=R, L=L, seed=SEED, device="cuda")
    n, nr, dev = ws.n, ws.n * R, ws.walks.device
    kw = dict(R=R, alpha=ws._alpha32, key=ws._key)
    open_steps = ws.total_steps
    dels, ins = random_batch(hg, 1e-4, seed=100, deletions_frac=0.2)
    touched = np.unique(np.concatenate([dels[:, 0], ins[:, 0]]))
    tm = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    tm[torch.as_tensor(touched, device=dev)] = True
    flags, _ = wk.walk_touch_cuda(ws.walks, tm, n_walks=nr)
    df_ids = flags.nonzero().reshape(-1).to(torch.int32)
    all_ids = torch.arange(nr, dtype=torch.int32, device=dev)
    live = (ws.walks[:nr] < n).sum(1)
    w_open, c_open = torch.empty_like(ws.walks), torch.empty_like(ws.counts)
    w_df, c_df = ws.walks.clone(), ws.counts.clone()

    def timed(fn, setup=None):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        if time.perf_counter() - t0 > HOLD_CYCLES / 2.5e9:
            raise SystemExit("queueing a call outlasted the sleep that holds "
                             "the stream")
        b.synchronize()
        return a.elapsed_time(b), out

    def fresh():
        w_open.fill_(n)
        c_open.zero_()

    def run_open():
        return timed(lambda: wk.walk_regen_cuda(w_open, c_open, ws.adj,
                                                ws.deg, all_ids, **kw),
                     setup=fresh)

    def run_df():
        return timed(lambda: wk.walk_regen_cuda(w_df, c_df, ws.adj, ws.deg,
                                                df_ids, **kw))

    def same(w, c, steps, want_steps):
        return (torch.equal(w, ws.walks) and torch.equal(c, ws.counts)
                and int(steps) == want_steps)

    df_steps = int(live[df_ids.long()].sum())
    counted = "WALK_PHASES" in wk._SRC.read_text()
    out = {"device": smi, "src": str(tree), "counters": counted,
           "ids": {"open": nr, "df_batch": int(df_ids.numel()),
                   "touched": int(touched.size)}}
    # -- the kernels as built ------------------------------------------------
    for name, run, want in (("open", run_open, open_steps),
                            ("df_batch", run_df, df_steps)):
        ms, ok = [], True
        for _ in range(reps):
            t, steps = run()
            ms.append(t)
            ok = ok and same(w_open if name == "open" else w_df,
                             c_open if name == "open" else c_df, steps, want)
        if not ok:
            raise SystemExit(f"walk_regen ({name}) differs from the open's "
                             "walks, counts or steps")
        out[name] = {"walk_regen_ms": ms, "host_thread_a_walk": divergence(
            live[(all_ids if name == "open" else df_ids).long()], L)}
    out["walk_touch_ms"] = [
        timed(lambda: wk.walk_touch_cuda(ws.walks, tm, n_walks=nr))[0]
        for _ in range(reps)]
    src = nvcc.BUILD_DIR / "walk_head_read.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(HEAD_READ)
    head = nvcc.Library(src, "walk_head_read", lambda lib: None).load()
    assert L % 4 == 0 and ws.walks.data_ptr() % 16 == 0
    byte = torch.empty(nr, dtype=torch.uint8, device=dev)

    def head_read():
        if head.head_read(ctypes.c_void_p(ws.walks.data_ptr()),
                          ctypes.c_longlong(nr), L, n,
                          ctypes.c_void_p(byte.data_ptr())) != 0:
            raise SystemExit("the head-read yardstick failed to launch")

    head_read()                           # the module's first launch loads it
    out["head_read_ms"] = [timed(head_read)[0] for _ in range(reps)]
    print(f"{tree}: walk_regen the open "
          f"{np.round(out['open']['walk_regen_ms'], 4).tolist()} ms, "
          f"one df batch's {int(df_ids.numel())} ids "
          f"{np.round(out['df_batch']['walk_regen_ms'], 4).tolist()} ms; "
          f"walk_touch ({int(touched.size)} touched) "
          f"{np.round(out['walk_touch_ms'], 4).tolist()} ms; the head-read "
          f"yardstick {np.round(out['head_read_ms'], 4).tolist()} ms; host, a "
          f"thread a walk over the open: {out['open']['host_thread_a_walk']}"
          f" [{smi}]", flush=True)
    if not counted:
        print(json.dumps(out))
        return

    # -- the counted build ---------------------------------------------------
    def bind(lib):
        wk._bind(lib)
        lib.walk_phases.argtypes = [ctypes.c_void_p]
        lib.walk_phases.restype = ctypes.c_int

    lib = nvcc.Library(wk._SRC, "walk_phases", bind,
                       flags=("-DWALK_PHASES",))
    wk._Library = lib                     # the wrapper now launches this build
    wk._BLOCKS_PER_SM.clear()             # this build's occupancy
    buf = (ctypes.c_ulonglong * 16)()
    for name, run, want in (("open", run_open, open_steps),
                            ("df_batch", run_df, df_steps)):
        if lib.load().walk_phases(buf) != 0:      # zero the counters
            raise SystemExit("reading the phase counters failed")
        t, steps = run()
        ok = same(w_open if name == "open" else w_df,
                  c_open if name == "open" else c_df, steps, want)
        if lib.lib.walk_phases(buf) != 0:
            raise SystemExit("reading the phase counters failed")
        P = list(buf)
        warps, total = max(P[10], 1), max(P[11], 1)
        row = out[name]
        row.update(
            counted_ms=t, counted_equals_kernel=ok, warps=P[10],
            loop_passes_a_warp=P[8] / warps,
            cycles_a_warp={k: P[i] / warps for i, k in enumerate(PHASES)},
            share={k: P[i] / total for i, k in enumerate(PHASES)},
            idle_lane_share=P[7] / (32 * total),
            block_slots_used_share=P[9] / max(64 * P[8], 1))
        print(f"{name}, counted build: {t:.4f} ms, equal to the kernel {ok}; "
              f"{P[10]} warps, {row['loop_passes_a_warp']:.1f} loop passes "
              f"a warp, cycles a warp "
              f"{ {k: round(v) for k, v in row['cycles_a_warp'].items()} }, "
              f"share { {k: round(v, 4) for k, v in row['share'].items()} }; "
              f"lane-cycles with no walk {row['idle_lane_share']:.4f}, cipher "
              f"blocks used of the two a lane a pass "
              f"{row['block_slots_used_share']:.4f}", flush=True)
        if not ok:
            raise SystemExit("the counted build differs from the kernel")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
