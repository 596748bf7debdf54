"""Deterministic thread-fault schedules (ports ``src/repro/core/faults.py``,
copied: numpy on the host).

The paper simulates random thread *delays* and *crash-stop* failures.  The
fused driver assigns compacted block slots round-robin to ``n_threads``
pseudo-threads, and a ``FaultPlan`` decides, per (pseudo-thread, sweep),
whether that thread's slots are processed; ``device_tables`` exports the
schedule as dense arrays the driver indexes on the device.  A
simulated-time model converts per-thread work into wall-clock analogues:
    sweep_time(LF) = max over alive threads of (edges·t_edge + blocks·t_block)
    iter_time(BB)  = max over all threads of the same plus their delay.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# calibration constants for the simulated-time model (arbitrary but fixed;
# results are reported as ratios, mirroring the paper's relative plots)
T_EDGE_NS = 1.0        # per-edge processing cost
T_BLOCK_NS = 2000.0    # per-block scheduling overhead


@dataclasses.dataclass
class FaultPlan:
    """Deterministic per-(thread, sweep) fault schedule."""

    n_threads: int = 64
    delay_prob: float = 0.0       # per-thread, per-sweep delay probability
    delay_ms: float = 0.0
    n_crashed: int = 0            # number of threads that crash
    crash_window: int = 64        # crashes occur at a random sweep in [0, w)
    seed: int = 0
    max_sweeps: int = 4096

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._delays = (rng.random((self.max_sweeps, self.n_threads))
                        < self.delay_prob)
        crash_at = np.full(self.n_threads, np.iinfo(np.int64).max)
        if self.n_crashed:
            who = rng.choice(self.n_threads, size=min(self.n_crashed,
                                                      self.n_threads),
                             replace=False)
            crash_at[who] = rng.integers(0, max(1, self.crash_window),
                                         size=len(who))
        self._crash_at = crash_at

    # -- queries -------------------------------------------------------------
    def alive(self, sweep: int) -> np.ndarray:
        return self._crash_at > sweep

    def delayed(self, sweep: int) -> np.ndarray:
        s = min(sweep, self.max_sweeps - 1)
        return self._delays[s] & self.alive(sweep)

    def participating(self, sweep: int) -> np.ndarray:
        """Threads that actually process their slots this sweep (LF)."""
        return self.alive(sweep) & ~self.delayed(sweep)

    def any_crashed(self, sweep: int) -> bool:
        return bool((~self.alive(sweep)).any())

    # -- simulated time -------------------------------------------------------
    def sweep_time_ms(self, sweep: int, thread_edges: np.ndarray,
                      thread_blocks: np.ndarray, *, barrier: bool) -> float:
        """Simulated duration of one sweep/iteration, in milliseconds."""
        work_ms = (thread_edges * T_EDGE_NS
                   + thread_blocks * T_BLOCK_NS) * 1e-6
        delay = self.delayed(sweep) * self.delay_ms
        if barrier:
            # delayed threads still finish before the barrier; everyone waits
            return float(np.max(work_ms + delay))
        alive = self.alive(sweep)
        if not alive.any():
            return 0.0
        return float(np.max(np.where(alive, work_ms, 0.0)))


    # -- device export (fused engine) ----------------------------------------
    def device_tables(self, max_iterations: int):
        """Precompute the per-(sweep, thread) fault schedule as dense arrays
        so a fully on-device driver can apply fault masks with zero host
        syncs: (participating, alive, delay_ms_row, any_crashed)."""
        s = min(max_iterations, self.max_sweeps)
        sweeps = np.arange(s)
        alive = self._crash_at[None, :] > sweeps[:, None]
        delayed = self._delays[:s] & alive
        part = alive & ~delayed
        delay_row = delayed * self.delay_ms
        crashed = (~alive).any(axis=1)
        if s < max_iterations:                      # clamp-extend final row
            def ext(a):
                return np.concatenate(
                    [a, np.repeat(a[-1:], max_iterations - s, axis=0)], 0)
            alive, part, delay_row, crashed = map(
                ext, (alive, part, delay_row, crashed))
        return (part.astype(bool), alive.astype(bool),
                delay_row.astype(np.float32), crashed.astype(bool))


NO_FAULTS = FaultPlan(n_threads=1)
