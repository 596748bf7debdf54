"""Where the blocked sweep kernel's time goes, phase by phase, on the card.

    python3 tools/sweep_phases.py

Builds ``grid_road(1024, seed=7)`` (n = 1,048,576; f64, B = 64, τ = 1e-10,
tile 512, as ``chip_smoke.py``'s phase 8 before its batches) and runs two
sweeps through ``kernels/blocked_sweep``: a cold LF sweep over all 16,384
slots from the initial ranks (no expansion), and an LF sweep with expansion
over the DF frontier of ``random_batch(hg, 1e-4, seed=800,
deletions_frac=0.2)`` from the cold solve's ranks.  Each is timed with CUDA
events over 3 launches of the kernel as built.  Then it builds the same
source with ``-DSWEEP_PHASES`` (the kernel's ``clock64()`` counters, under
a library name of its own), runs the same sweeps through that build and
prints the cycles a slot (consumer thread 0: waiting for the item, the
staged flags, the folds resumed at a pending read, the ranks and the vote,
the expansion, the slot's end) and an item (producer warp 0: finding the
item's slot, waiting for a free entry, staging, the bulk copies, the
gathers and prefix folds, the out-edges).  The counters cost time
themselves (their sweeps run slower than the plain build's), and the
counted build must still equal the kernel (checked).  Prints, as its last
line, one JSON object with the card's name and power limit and every
number.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TAU = 1e-10
CONSUMER = ("wait", "flags", "fold", "ranks_vote", "expand", "end")
PRODUCER = ("find_slot", "wait_free", "stage", "bulk_copy", "gather_fold",
            "out_edges")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    from repro_torch.core import blocked as blk
    from repro_torch.core import frontier as fr
    from repro_torch.core import pagerank as pr
    from repro_torch.core.delta import random_batch
    from repro_torch.core.graph import initial_ranks, pad_ranks
    from repro_torch.graphs.generators import grid_road
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.blocked_sweep import blocked_sweep as bws

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    hg = grid_road(1024, seed=7)
    g3 = hg.snapshot(block_size=64, device="cuda")
    nb = g3.n_blocks
    dev_false = torch.zeros(1, dtype=torch.bool, device="cuda")
    dels, ins = random_batch(hg, 1e-4, seed=800, deletions_frac=0.2)
    g4 = hg.apply_batch(dels, ins).snapshot(block_size=64, device="cuda")
    aff = fr.initial_affected(g3, g4, fr.batch_to_device(g4, dels, ins))
    ids, n_act = blk.active_blocks(aff, n_blocks=nb, block_size=64)
    n_act = int(n_act)
    K = blk.slot_capacity(n_act, nb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cold = pr.static_pagerank(g3, mode="lf", engine="blocked", tau=TAU)
    cases = {
        f"cold, {nb} slots": (g3, initial_ranks(g3),
                              torch.cat([g3.vertex_valid, dev_false]),
                              torch.arange(nb, dtype=torch.int32,
                                           device="cuda"),
                              torch.ones(nb, dtype=torch.bool,
                                         device="cuda"), False),
        f"DF frontier, {n_act} of {K} slots": (
            g4, pad_ranks(g4, cold.ranks), torch.cat([aff, dev_false]),
            ids[:K].contiguous(), torch.arange(K, device="cuda") < n_act,
            True)}

    def sweep(case):
        g, R0, a0, sl, mask, expand = case
        R, A, C = R0.clone(), a0.clone(), a0.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m, e = bws.blocked_sweep_cuda(
            blk.sweep_graph(g, R0.dtype), R, R, A, C, sl, mask, n=g.n,
            alpha=0.85, tau=TAU, tau_f=TAU / 1000.0 if expand
            else float("inf"), tile=512, expand=expand, jacobi=False)
        end.record()
        end.synchronize()
        return start.elapsed_time(end), (R, A, C, m, e)

    out = {"device": smi, "sweeps": {}}
    plain = {}
    for name, case in cases.items():
        ms = [sweep(case)[0] for _ in range(3)]
        plain[name] = sweep(case)[1]
        out["sweeps"][name] = {"kernel_ms": ms}
        print(f"{name}: kernel {np.round(ms, 4).tolist()} ms [{smi}]",
              flush=True)

    lib = nvcc.Library(bws._SRC, "blocked_sweep_phases", bws._bind,
                       flags=("-DSWEEP_PHASES",))
    bws._Library = lib                     # the wrapper now launches this build
    lib.load().blocked_sweep_phases.argtypes = [ctypes.c_void_p]
    for name, case in cases.items():
        ms = [sweep(case)[0] for _ in range(3)]
        same = all(torch.equal(a, b) for a, b in zip(sweep(case)[1],
                                                     plain[name]))
        buf = (ctypes.c_ulonglong * 16)()
        if lib.lib.blocked_sweep_phases(buf) != 0:
            raise SystemExit("reading the phase counters failed")
        P = list(buf)
        slots, items = max(P[6], 1), max(P[14], 1)
        row = out["sweeps"][name]
        row.update(counted_ms=ms, counted_equals_kernel=same,
                   consumer_slots=P[6], producer0_items=P[14],
                   consumer_cycles_a_slot={k: P[i] / slots for i, k in
                                           enumerate(CONSUMER)},
                   producer0_cycles_an_item={k: P[8 + i] / items for i, k in
                                             enumerate(PRODUCER)})
        print(f"{name}: with counters {np.round(ms, 4).tolist()} ms, equal "
              f"to the kernel {same}; consumer cycles a slot "
              f"{ {k: round(v) for k, v in row['consumer_cycles_a_slot'].items()} }; "
              f"producer warp 0 cycles an item "
              f"{ {k: round(v) for k, v in row['producer0_cycles_an_item'].items()} }",
              flush=True)
        if not same:
            raise SystemExit("the counted build differs from the kernel")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
