"""PageRank variants — Static / ND / DT / DF × BB / LF (ports
``src/repro/core/pagerank.py``).

Three engines of the port back the variants (``repro_torch.api.registry``):

  * ``dense``   — full-SpMV Jacobi over every vertex (:func:`dense_jacobi`):
                  oracle-grade, no kernel; its LF mode is the blocked engine;
  * ``blocked`` — in-order Gauss–Seidel sweeps over the active blocks
                  (:mod:`repro_torch.core.blocked`, on the hand-written
                  sweep kernel): the paper's lock-free semantics and the
                  fault-model oracle;
  * ``pallas``  — the fused frontier engine
                  (:mod:`repro_torch.core.pallas_engine`) on the
                  hand-written tile-SpMV kernels.

Variant = (initial ranks, initial affected set, expand?) × (mode):
    Static : R0 = 1/n,      affected = all,              expand = off
    ND     : R0 = R^{t-1},  affected = all,              expand = off
    DT     : R0 = R^{t-1},  affected = reachable(Δ),     expand = off
    DF     : R0 = R^{t-1},  affected = out-nbrs(src(Δ)), expand = on (τ_f)

Also here: the legacy ``static_/nd_/dt_/df_pagerank`` functions —
deprecated shims over a snapshot-mode
:class:`repro_torch.api.session.PageRankSession` — and the oracles
(:func:`reference_pagerank`, :func:`numpy_reference`,
:func:`ppr_numpy_reference`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blocked as blk
from repro_torch.core import frontier as fr
from repro_torch.core.blocked import SweepStats
from repro_torch.core.graph import (GraphSnapshot, initial_ranks, pad_ranks,
                                    pull_all)

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


def default_dtype() -> torch.dtype:
    """The port's rank dtype when none is given: f64, the paper's (the
    reference's follows JAX's x64 switch)."""
    return torch.float64


def default_engine() -> str:
    """Engine used when a variant is called with ``engine=None``
    (:func:`repro_torch.api.registry.default_engine`)."""
    from repro_torch.api import registry
    return registry.default_engine()


# ---------------------------------------------------------------------------
# dense engine (oracle-grade, full work every iteration)
# ---------------------------------------------------------------------------

def dense_jacobi(g: GraphSnapshot, R0, affected0, *, expand: bool,
                 alpha: float = DEFAULT_ALPHA, tau: float = DEFAULT_TAU,
                 tau_f: Optional[float] = None,
                 max_iterations: int = MAX_ITERATIONS,
                 personalization=None) -> Tuple[torch.Tensor, int, bool]:
    """Barrier-based engine: masked full-SpMV per iteration (Alg. 1/3/5/7).
    Returns (ranks, iterations, converged).  ``personalization`` (restart
    distribution [n_pad]) swaps the uniform teleport for a personalized
    one.  The loop reads the iteration's ``max |ΔR|`` on the host once per
    iteration (the reference's ``lax.while_loop`` condition)."""
    tau_f = (tau / 1000.0) if (expand and tau_f is None) else (
        tau_f if tau_f is not None else float("inf"))
    zero = torch.zeros((), dtype=R0.dtype, device=R0.device)
    R = torch.where(g.vertex_valid, R0[:g.n_pad], zero)
    affected = affected0[:g.n_pad] & g.vertex_valid
    dR = torch.tensor(float("inf"), dtype=R.dtype, device=R.device)
    i = 0
    while bool(dR > tau) and i < max_iterations:
        r_all = pull_all(g, R, alpha=alpha, personalization=personalization)
        r_new = torch.where(affected, r_all, R)
        dr = (r_new - R).abs()
        if expand:
            changed = affected & (dr > tau_f)
            affected, _ = fr.expand_frontier(g, changed, affected,
                                             torch.zeros_like(affected))
        R, dR, i = r_new, dr.max(), i + 1
    return R, i, bool(dR <= tau)


# ---------------------------------------------------------------------------
# legacy variant functions — deprecated shims over PageRankSession
# ---------------------------------------------------------------------------
#
# Each builds the snapshot-mode session the call routes through and
# converges through it: the session path is the implementation, bit for bit.
# Unknown keywords are rejected with the valid-key list.

_LEGACY_KEYS = ("alpha", "tau", "tau_f", "max_iterations", "faults", "tile",
                "active_policy", "pallas_mat", "pallas_aux", "pallas_backend")


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.pagerank.{old}() is deprecated; use "
        f"repro_torch.api.{new} instead (docs/API.md has the migration "
        "table)", DeprecationWarning, stacklevel=3)


def _legacy_session(g: GraphSnapshot, R0, *, mode: str,
                    engine: Optional[str], dtype=None, kw: dict):
    """The session a legacy variant call routes through, plus the pallas
    engine's per-call operands split out of the legacy kwargs.
    ``pallas_backend`` goes to ``EngineConfig(backend=)``, which accepts
    only ``None``."""
    unknown = sorted(set(kw) - set(_LEGACY_KEYS))
    if unknown:
        raise TypeError(
            f"unknown keyword argument(s) {unknown} for a PageRank "
            f"variant; valid keys: {sorted(_LEGACY_KEYS)}")
    kw = dict(kw)
    mat = kw.pop("pallas_mat", None)
    aux = kw.pop("pallas_aux", None)
    backend = kw.pop("pallas_backend", None)
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.session import PageRankSession
    cfg = EngineConfig.from_kwargs(mode=mode, engine=engine,
                                   backend=backend, dtype=dtype, **kw)
    sess = PageRankSession.from_snapshot(g, config=cfg, r0=R0)
    return sess, mat, aux


def static_pagerank(g: GraphSnapshot, *, mode: str = "bb",
                    engine: Optional[str] = None, dtype=None, **kw
                    ) -> PagerankResult:
    """Deprecated: use ``PageRankSession.recompute(variant="static")``."""
    _deprecated("static_pagerank", 'PageRankSession.recompute("static")')
    R0 = initial_ranks(g, dtype or default_dtype())
    sess, mat, aux = _legacy_session(g, R0, mode=mode, engine=engine,
                                     dtype=dtype, kw=kw)
    return sess._converge(R0, g.vertex_valid, expand=False, mat=mat,
                          aux=aux)


def nd_pagerank(g: GraphSnapshot, r_prev, *, mode: str = "bb",
                engine: Optional[str] = None, **kw) -> PagerankResult:
    """Deprecated: use ``PageRankSession.recompute(variant="nd")``."""
    _deprecated("nd_pagerank", 'PageRankSession.recompute("nd")')
    R0 = pad_ranks(g, r_prev)
    sess, mat, aux = _legacy_session(g, R0, mode=mode, engine=engine, kw=kw)
    return sess._converge(R0, g.vertex_valid, expand=False, mat=mat,
                          aux=aux)


def dt_pagerank(g_prev: GraphSnapshot, g: GraphSnapshot, batch: torch.Tensor,
                r_prev, *, mode: str = "bb", engine: Optional[str] = None,
                **kw) -> PagerankResult:
    """Deprecated: use ``PageRankSession.update(..., variant="dt")``."""
    _deprecated("dt_pagerank", 'PageRankSession.update(variant="dt")')
    affected = fr.dt_affected(g_prev, g, batch)
    R0 = pad_ranks(g, r_prev)
    sess, mat, aux = _legacy_session(g, R0, mode=mode, engine=engine, kw=kw)
    return sess._converge(R0, affected, expand=False, mat=mat, aux=aux)


def df_pagerank(g_prev: GraphSnapshot, g: GraphSnapshot, batch: torch.Tensor,
                r_prev, *, mode: str = "lf", engine: Optional[str] = None,
                helping_first_pass=None, **kw) -> PagerankResult:
    """DF_BB (mode="bb") / DF_LF (mode="lf"), Algorithms 1 & 2;
    ``helping_first_pass`` [b_pad] marks through the helping mechanism
    (:func:`repro_torch.core.frontier.initial_affected_with_helping`).

    Deprecated: use ``PageRankSession.update`` for dynamic streams."""
    _deprecated("df_pagerank", "PageRankSession.update")
    if helping_first_pass is not None:
        affected, _, _ = fr.initial_affected_with_helping(
            g_prev, g, batch, helping_first_pass)
    else:
        affected = fr.initial_affected(g_prev, g, batch)
    R0 = pad_ranks(g, r_prev)
    sess, mat, aux = _legacy_session(g, R0, mode=mode, engine=engine, kw=kw)
    return sess._converge(R0, affected, expand=True, mat=mat, aux=aux)


# ---------------------------------------------------------------------------
# reference oracles (paper §5.1.5: barrier-based static, ≤500 iterations)
# ---------------------------------------------------------------------------

def reference_pagerank(g: GraphSnapshot, *, alpha: float = DEFAULT_ALPHA,
                       iterations: int = MAX_ITERATIONS, dtype=None
                       ) -> torch.Tensor:
    """``iterations`` full pull steps from the uniform vector, on the
    snapshot's device (no host read)."""
    R = initial_ranks(g, dtype or default_dtype())
    for _ in range(iterations):
        R = pull_all(g, R, alpha=alpha)
    return R


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


def restart_vector(g: GraphSnapshot, seeds, dtype=np.float64) -> np.ndarray:
    """Uniform restart distribution [n_pad] over a seed set — the
    ``personalization`` operand of :func:`dense_jacobi` / ``pull_all``."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    if seeds.size == 0:
        raise ValueError("restart_vector needs at least one seed vertex")
    if (seeds < 0).any() or (seeds >= g.n).any():
        raise ValueError(f"seed(s) out of range for a graph with {g.n} "
                         "vertices")
    p = np.zeros(g.n_pad, np.dtype(dtype))
    np.add.at(p, seeds, 1.0 / seeds.size)
    return p


def ppr_numpy_reference(g: GraphSnapshot, seeds, *,
                        alpha: float = DEFAULT_ALPHA,
                        iterations: int = 200) -> np.ndarray:
    """Independent numpy oracle (f64) for personalized PageRank with a
    uniform restart over ``seeds`` — :func:`numpy_reference`'s pull with
    the personalized teleport."""
    n_pad = g.n_pad
    src = g.src[:g.m].cpu().numpy()
    dst = g.dst[:g.m].cpu().numpy()
    deg = np.maximum(g.out_deg.cpu().numpy(), 1).astype(np.float64)
    p = restart_vector(g, seeds)
    R = p.copy()
    for _ in range(iterations):
        c = R / deg
        pulled = np.bincount(dst, weights=c[src], minlength=n_pad)[:n_pad]
        R_new = (1 - alpha) * p + alpha * pulled
        R_new[g.n:] = 0
        R = R_new
    return R


def linf(a, b) -> float:
    """L∞ distance of two rank vectors (tensors or arrays)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# registry adapter (discovered lazily by repro_torch.api.registry)
# ---------------------------------------------------------------------------

class DenseEngine:
    """Registry adapter for the oracle-grade dense engine: masked full-SpMV
    Jacobi in BB mode; LF mode reuses the blocked engine (dense LF ==
    blocked with every block active)."""

    name = "dense"
    fault_domains = ("thread", "process")

    def run(self, g, R0, affected0, *, mode, expand, alpha, tau, tau_f,
            max_iterations, faults, tile, active_policy,
            mat=None, aux=None, backend=None, shards=None):
        from repro_torch.api.registry import (reject_shard_spec,
                                              reject_tile_operands)
        reject_tile_operands(self.name, mat, aux, backend)
        reject_shard_spec(self.name, shards)
        if mode == "bb":
            R, iters, conv = dense_jacobi(
                g, R0, affected0, expand=expand, alpha=alpha, tau=tau,
                tau_f=tau_f, max_iterations=max_iterations)
            return R, SweepStats(sweeps=iters, iterations=iters,
                                 converged=conv, edges_processed=iters * g.m)
        return blk.run_blocked(
            g, R0, affected0, mode="lf", expand=expand, alpha=alpha,
            tau=tau, tau_f=tau_f, max_iterations=max_iterations,
            tile=tile, faults=faults, active_policy=active_policy)


def as_engine() -> DenseEngine:
    return DenseEngine()
