"""Sweep statistics of the engines (ports ``SweepStats`` from
``src/repro/core/blocked.py``; the blocked Gauss–Seidel engine itself is a
later slice)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SweepStats:
    sweeps: int = 0
    iterations: int = 0           # BB barrier iterations (== sweeps for LF)
    blocks_processed: int = 0
    edges_processed: int = 0
    sim_time_ms: float = 0.0
    converged: bool = False
    dnf: bool = False             # BB stalled at barrier due to a crash
