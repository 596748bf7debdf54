"""Stream-driving wrappers over the port's session (ports
``src/repro/core/stream.py``: ``StreamReport``, ``StreamRunner``,
``run_stream``).

:class:`StreamRunner` opens one stream-mode
:class:`repro_torch.api.session.PageRankSession` from an
:class:`~repro_torch.api.config.EngineConfig` and steps it batch by batch;
:func:`run_stream` drives a whole batch stream and aggregates p50/p95
latency and the kernel builds after warmup (the port's retrace count).
Differences from the reference: ``device="cuda"`` by default, as every
entry point of the port; the engine options are ``EngineConfig``'s own
(given as ``config=`` or as its keyword fields, ``driver=`` among them)
rather than a copy of them; no ``interpret``/``backend`` (the tensors'
device picks kernel or plain version).  A durable stream takes
``durability="wal"`` among the fields and its store as ``store_dir=``.

As in the reference, the runner forwards the session state it holds
(``hg``, ``R``, ``inc``, ``valid``, ``n``, ``n_pad``, ``block_size``,
``n_rb``, ``mode``, ``active_policy``, ``max_iterations`` and the operand
mirrors ``_out_deg``, ``_rb_in``, ``_rb_out``, ``_bmat``), and the module
re-exports ``StreamBatchResult``, ``_seed_affected`` and
``_apply_operand_delta`` of :mod:`repro_torch.api.session`, resolved
lazily (PEP 562) because the session module imports this package.  The
reference's ``_driver_cache_size`` (a jit-cache size) has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.core.graph import HostGraph

if TYPE_CHECKING:
    from repro_torch.api.session import StreamBatchResult

__all__ = ["StreamRunner", "StreamBatchResult", "StreamReport", "run_stream",
           "_seed_affected", "_apply_operand_delta"]

_SESSION_EXPORTS = ("StreamBatchResult", "_seed_affected",
                    "_apply_operand_delta")


def __getattr__(name: str):
    if name in _SESSION_EXPORTS:
        from repro_torch.api import session
        return getattr(session, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class StreamReport:
    """Aggregate latency/build/convergence statistics over a stream."""
    results: List[StreamBatchResult]
    wall_times_s: List[float]
    p50_s: float
    p95_s: float
    retraces_post_warmup: int     # kernel builds after warmup (or batch 1)
    batches_converged: int = 0    # batches that met tau within the cap
    sweep_cap_hits: int = 0       # batches stopped by max_iterations instead

    @property
    def final_ranks(self) -> torch.Tensor:
        return self.results[-1].ranks

    @property
    def all_converged(self) -> bool:
        return self.sweep_cap_hits == 0


class StreamRunner:
    """Drives DF_LF PageRank (``driver="pull"``) or the residual forward
    push (``driver="push"``) along a dynamic edge stream::

        runner = StreamRunner(hg0, EngineConfig(driver="push"))
        for dels, ins in batches:
            res = runner.step(dels, ins)     # converged ranks + latency

    ``config=None`` builds ``EngineConfig(**fields)``; ``store_dir`` is
    the store of a ``durability="wal"`` config.  The vertex set (and
    hence the block grid) is fixed for the lifetime of the runner.
    ``r0=None`` runs one initial solve on the initial graph."""

    def __init__(self, hg0: HostGraph, config: Optional[EngineConfig] = None,
                 *, r0=None, device="cuda", store_dir: Optional[str] = None,
                 **fields):
        # imported here: core/ sits below api/ in the package's layering
        from repro_torch.api.session import PageRankSession
        cfg = config if config is not None else EngineConfig(**fields)
        self.session = PageRankSession.from_graph(hg0, config=cfg, r0=r0,
                                                  device=device,
                                                  store_dir=store_dir)

    def warmup(self) -> None:
        """See :meth:`PageRankSession.warmup`."""
        self.session.warmup()

    def step(self, deletions: np.ndarray, insertions: np.ndarray
             ) -> StreamBatchResult:
        """Apply one edge batch and reconverge."""
        return self.session.update(deletions, insertions)

    # -- state passthroughs (the session owns the stream state) -------------
    @property
    def hg(self) -> HostGraph:
        return self.session.hg

    @property
    def R(self) -> torch.Tensor:
        return self.session.R

    @property
    def inc(self):
        return self.session.inc

    @property
    def valid(self) -> torch.Tensor:
        return self.session.valid

    @property
    def n(self) -> int:
        return self.session.n

    @property
    def n_pad(self) -> int:
        return self.session.n_pad

    @property
    def block_size(self) -> int:
        return self.session.block_size

    @property
    def n_rb(self) -> int:
        return self.session.n_rb

    @property
    def mode(self) -> str:
        return self.session.config.mode

    @property
    def active_policy(self) -> str:
        return self.session.config.active_policy

    @property
    def max_iterations(self) -> int:
        return self.session.config.max_iterations

    @property
    def _out_deg(self) -> torch.Tensor:
        return self.session._out_deg

    @property
    def _rb_in(self) -> torch.Tensor:
        return self.session._rb_in

    @property
    def _rb_out(self) -> torch.Tensor:
        return self.session._rb_out

    @property
    def _bmat(self) -> torch.Tensor:
        return self.session._bmat


def run_stream(hg0: HostGraph,
               batches: Iterable[Tuple[np.ndarray, np.ndarray]],
               warmup: bool = True, **runner_kwargs) -> StreamReport:
    """Run a whole stream of (deletions, insertions) batches and aggregate
    per-batch latency (p50/p95) and the kernel builds after warmup.
    Keyword arguments (``config=``, ``r0=``, ``device=`` or
    ``EngineConfig`` fields) are forwarded to :class:`StreamRunner`.

    ``warmup=True`` runs :meth:`StreamRunner.warmup` first (not recorded),
    so the build count covers every recorded batch; without it the first
    batch's builds are excluded."""
    runner = StreamRunner(hg0, **runner_kwargs)
    if warmup:
        runner.warmup()
    results = [runner.step(dels, ins) for dels, ins in batches]
    if not results:
        raise ValueError("empty stream")
    walls = [r.wall_time_s for r in results]
    counted = results if warmup else results[1:]
    converged = sum(1 for r in results if r.stats.converged)
    return StreamReport(
        results=results, wall_times_s=walls,
        p50_s=float(np.percentile(walls, 50)),
        p95_s=float(np.percentile(walls, 95)),
        retraces_post_warmup=sum(r.driver_retraces for r in counted),
        batches_converged=converged,
        sweep_cap_hits=len(results) - converged)
