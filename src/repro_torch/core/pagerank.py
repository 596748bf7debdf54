"""The port's own oracle (ports ``numpy_reference``, ``linf`` and
``PagerankResult`` from ``src/repro/core/pagerank.py``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.blocked import SweepStats
from repro_torch.core.graph import GraphSnapshot

DEFAULT_ALPHA = 0.85
DEFAULT_TAU = 1e-10          # paper: 1e-10 (f64)
MAX_ITERATIONS = 500


@dataclasses.dataclass
class PagerankResult:
    ranks: torch.Tensor             # [n_pad]
    stats: SweepStats
    wall_time_s: float = 0.0

    @property
    def converged(self) -> bool:
        return self.stats.converged


def numpy_reference(g: GraphSnapshot, *, alpha: float = DEFAULT_ALPHA,
                    iterations: int = 200) -> np.ndarray:
    """Independent numpy oracle (f64): ``iterations`` Jacobi pull steps from
    the uniform vector over the snapshot's edges (self-loops included)."""
    n, n_pad = g.n, g.n_pad
    src = g.src[:g.m].cpu().numpy()
    dst = g.dst[:g.m].cpu().numpy()
    deg = np.maximum(g.out_deg.cpu().numpy(), 1).astype(np.float64)
    R = np.full(n_pad, 1.0 / n)
    R[n:] = 0
    for _ in range(iterations):
        c = R / deg
        pulled = np.bincount(dst, weights=c[src], minlength=n_pad)[:n_pad]
        R_new = (1 - alpha) / n + alpha * pulled
        R_new[n:] = 0
        R = R_new
    return R


def linf(a, b) -> float:
    """L∞ distance of two rank vectors (tensors or arrays)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    return float((a - b).abs().max())
