"""Per-update wall of the port's pull and push ``df`` streams on the main
path's graph, for comparing two trees of the port on one card.

    python3 tools/stream_walls.py [--src DIR] [--integrity]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
``grid_road(1024, seed=7)`` (n = 1,048,576; f64, B = 64, τ = 1e-10, as
``chip_smoke.py``'s phases 3 and 6), opens the untiered pull session and
then the push session, and streams 24 ``df`` batches into each: batch i is
``random_batch(hg, 1e-4, seed=100 + i, deletions_frac=0.2)`` of the pull
session's graph, as in phase 3.  ``--integrity`` opens the pull session
with ``integrity=IntegrityConfig(mass_tol=n * τ, auto_repair=False)`` and
skips the push stream (the push driver refuses ``integrity=``).  Prints,
as its last line, one JSON object: the card's name and power limit and,
per driver, the walls (ms), their p50 and the host syncs.

Compare two trees within one call, alternating them (parent, change,
change, parent): a card below its power limit, or a busier host, moves
every time between calls.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SIDE, BLOCK, TAU = 1024, 64, 1e-10
UPDATES = 24


def _stream(sess, batches) -> dict:
    walls, syncs = [], []
    for dels, ins in batches:
        res = sess.update(dels, ins, variant="df")
        torch.cuda.synchronize()
        if not res.converged:
            raise SystemExit("a df update did not converge")
        walls.append(res.wall_time_s * 1e3)
        syncs.append(res.host_syncs)
    return {"p50_ms": float(np.percentile(walls, 50)), "walls_ms": walls,
            "host_syncs": syncs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--integrity", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    src = Path(args.src).resolve() / "src"
    sys.path.insert(0, str(src))
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    from repro_torch.core.delta import random_batch
    from repro_torch.graphs.generators import grid_road

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    hg = grid_road(SIDE, seed=7)
    extra = {}
    if args.integrity:
        from repro_torch.api import IntegrityConfig
        extra["integrity"] = IntegrityConfig(mass_tol=hg.n * TAU,
                                             auto_repair=False)
    out = {"src": str(src), "card": smi, "updates": UPDATES,
           "integrity": args.integrity}
    t0 = time.perf_counter()
    pull = PageRankSession.from_graph(
        hg, config=EngineConfig(block_size=BLOCK, dtype=torch.float64,
                                tau=TAU, **extra), device="cuda")
    pull.warmup()
    out["pull_open_s"] = time.perf_counter() - t0
    batches = []

    def pull_batches():
        # each of the pull session's graph just before its update
        for i in range(UPDATES):
            batches.append(random_batch(pull.hg, 1e-4, seed=100 + i,
                                        deletions_frac=0.2))
            yield batches[-1]

    out["pull"] = _stream(pull, pull_batches())
    pull.close()
    del pull
    torch.cuda.empty_cache()
    if not args.integrity:
        push = PageRankSession.from_graph(
            hg, config=EngineConfig(block_size=BLOCK, dtype=torch.float64,
                                    tau=TAU, driver="push"), device="cuda")
        push.warmup()
        out["push"] = _stream(push, batches)
        push.close()
    print(f"{Path(src).parent.name or src}: pull p50 "
          f"{out['pull']['p50_ms']:.2f} ms"
          + (f", push p50 {out['push']['p50_ms']:.2f} ms"
             if "push" in out else "") + f" [{smi}]", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
