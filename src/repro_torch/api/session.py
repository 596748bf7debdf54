"""`PageRankSession` — one stateful handle for streams and snapshots.

Ports the untiered, single-device stream and snapshot modes of
``src/repro/api/session.py``: ``_seed_affected``, ``_apply_operand_delta``,
``from_graph``, ``from_snapshot``, ``_init_stream``, ``_init_snapshot``,
``_converge``, ``_drive``, ``_drive_push``, ``_residual_recompute``,
``_seed_push``, ``_update_stream``, ``_update_snapshot``, ``update`` (all
four variants), ``recompute`` (``static``/``nd``, and the ``df``/``dt``
replay of the last batch), ``query``, ``top_k``, ``ranks``, ``warmup``,
``close`` and ``report``::

    from repro_torch.api.session import PageRankSession
    from repro_torch.api.config import EngineConfig

    sess = PageRankSession.from_graph(hg, config=EngineConfig(tau=1e-10))
    sess.update(dels, ins)          # DF_LF step on the card
    sess.query([3, 17, 42])         # device gather, only the values move
    sess.top_k(10)

    push = PageRankSession.from_graph(
        hg, config=EngineConfig(tau=1e-10, driver="push"))
    push.update(dels, ins)          # residual seed + forward push

Two modes, picked at construction:

* **stream mode** (``from_graph`` + the pallas engine): the graph is
  snapshotted once; the capacity-padded pull matrix and the per-vertex /
  per-block engine operands live on the device and are patched in
  O(batch) per update; every update re-enters the fused pull driver of
  :mod:`repro_torch.core.pallas_engine` or, with ``driver="push"``, the
  push driver of :mod:`repro_torch.core.push_engine`, whose session keeps
  a residual beside the ranks and seeds it per batch on the host.  The
  ``dt`` marking (pull only) walks two throwaway snapshots per update, as
  the reference's does.
* **snapshot mode** (``from_snapshot``, or the ``blocked`` and ``dense``
  engines): the session holds a
  :class:`~repro_torch.core.graph.GraphSnapshot` on its device, rebuilds it
  per update (O(m) host work) and converges through the engine adapter of
  :mod:`repro_torch.api.registry`.  The legacy
  ``static/nd/dt/df_pagerank`` functions of
  :mod:`repro_torch.core.pagerank` are shims over exactly this path.

One ordering differs from the reference, because the port patches the tile
pool and its packed index in place: the DF seed's OR pass over G^{t-1} runs
*before* the tile scatter and index refresh, on the same stream, and its
pass over G^t after them (the JAX session keeps both pools and runs both
passes after the scatter).  The marking is the same.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api import registry
from repro_torch.api.config import EngineConfig
from repro_torch.core import fault_domain
from repro_torch.core import faults as flt
from repro_torch.core import frontier as fr
from repro_torch.core import pallas_engine as pe
from repro_torch.core import push_engine as pshe
from repro_torch.core.blocked import SweepStats
from repro_torch.core.delta import signed_edge_delta, validate_edge_batch
from repro_torch.core.graph import (GraphSnapshot, HostGraph,
                                    initial_ranks, pad_ranks)
from repro_torch.core.incremental import (IncrementalPullMatrix,
                                          effective_batch)
from repro_torch.core.pagerank import PagerankResult
from repro_torch.device import resolve_device
from repro_torch.kernels import nvcc
from repro_torch.kernels.block_spmv import ops

VARIANTS = ("static", "nd", "dt", "df")


class SweepCapWarning(RuntimeWarning):
    """An update batch hit ``max_iterations`` without converging — the
    served ranks are the best iterate, not a ``tau``-converged solution."""


# ---------------------------------------------------------------------------
# streaming machinery
# ---------------------------------------------------------------------------

def _block_rows(flags: torch.Tensor, block_size: int) -> torch.Tensor:
    return flags[:, None].expand(-1, block_size).reshape(-1)


def _seed_sources(bmat: torch.Tensor, batch: torch.Tensor,
                  valid: torch.Tensor, *, block_size: int):
    """Source indicator of a packed batch and the candidate row-blocks that
    own a tile in a source's column-block: (f, cand, cand ids, count)."""
    n_pad = valid.shape[0]
    n_rb = n_pad // block_size
    ind = torch.zeros(n_pad + 1, dtype=torch.bool, device=valid.device)
    ind[batch[:, 0].long().clamp(max=n_pad)] = True
    f = ind[:n_pad] & valid
    sb = fr.block_any(f, n_rb, block_size)
    cand = (bmat & sb[None, :]).any(dim=1)
    return f, cand, fr.compact_block_ids(cand, n_rb), cand.sum()


def _seed_pass(mat: ops.BlockSparse, seed) -> torch.Tensor:
    """OR pass of the seed over one graph's pull matrix (rows of
    non-candidate blocks are undefined; :func:`_seed_mask` drops them)."""
    f, _, cids, n_cand = seed
    return ops.block_spmv_active_bucketed(
        mat, f.to(mat.tiles.dtype), cids, n_cand, semiring="or") > 0


def _seed_mask(hit: torch.Tensor, seed, valid: torch.Tensor, *,
               block_size: int) -> torch.Tensor:
    return hit & _block_rows(seed[1], block_size) & valid


def _seed_affected(mat_prev: ops.BlockSparse, mat_new: ops.BlockSparse,
                   bmat, batch, valid, *, block_size: int) -> torch.Tensor:
    """Initial DF frontier for one batch (paper Alg. 1 lines 4-6): mark the
    out-neighbors of every update source in G^{t-1} *and* G^t, through both
    graphs' pull matrices, launching only over the candidate row-blocks
    (``bmat`` is the post-batch tile presence, a superset of the pre-batch
    one).  ``mat_prev`` must still hold the pre-batch tile values and the
    pre-batch packed index (the CUDA kernels read the index); the session,
    whose tile pool and index ``apply_delta`` patches in place, runs the two
    passes around the patch instead of calling this."""
    seed = _seed_sources(bmat, batch, valid, block_size=block_size)
    hit = _seed_pass(mat_prev, seed) | _seed_pass(mat_new, seed)
    return _seed_mask(hit, seed, valid, block_size=block_size)


def _apply_operand_delta(out_deg, rb_in, rb_out, bmat, rows, cols, vals, *,
                         block: int):
    """O(batch) in-place update of the engine-operand mirrors from the
    signed pull-layout delta (rows = dst, cols = src, vals = ±1 tensors on
    the mirrors' device).  Integer scatters, so their order is immaterial."""
    n_rb = rb_in.shape[0]
    rb = (rows // block).clamp(max=n_rb - 1)
    cb = (cols // block).clamp(max=n_rb - 1)
    out_deg.index_add_(0, cols, vals.to(out_deg.dtype))
    rb_in.index_add_(0, rb, vals.to(rb_in.dtype))
    rb_out.index_add_(0, cb, vals.to(rb_out.dtype))
    bmat[rb, cb] = True
    return out_deg, rb_in, rb_out, bmat


@dataclasses.dataclass
class StreamBatchResult:
    """Outcome of one update step."""
    ranks: torch.Tensor           # [n_pad] post-batch converged ranks
    stats: SweepStats
    wall_time_s: float            # full step: delta + seed + converge
    batch_edges: int              # raw batch size (before no-op filtering)
    driver_retraces: int = 0      # kernel builds during this step
    host_syncs: int = 0           # device-to-host reads (stream mode)
    # -- push-driver accounting (None on the pull driver) --------------------
    residual_mass: Optional[float] = None     # ‖r‖₁ at drive exit
    pushed_blocks: Optional[int] = None       # source blocks pushed

    @property
    def converged(self) -> bool:
        return bool(self.stats.converged)


@dataclasses.dataclass
class SessionReport:
    """Aggregate latency / work statistics of a session."""
    engine: str
    device: str
    mode: str
    n_updates: int
    p50_s: float
    p95_s: float
    retraces_post_warmup: int     # kernel builds after warmup
    total_sweeps: int
    total_edges_processed: int
    queries_served: int
    wall_times_s: List[float]
    batches_converged: int = 0
    sweep_cap_hits: int = 0
    topology: str = "single"
    durability: str = "none"
    device_bytes: Optional[dict] = None
    bytes_per_vertex: Optional[float] = None
    driver: str = "pull"
    sweeps_history: List[int] = dataclasses.field(default_factory=list)
    edges_processed_history: List[int] = dataclasses.field(
        default_factory=list)
    host_syncs_history: List[int] = dataclasses.field(default_factory=list)
    residual_mass_last: Optional[float] = None  # push: ‖r‖₁ at last exit
    pushed_blocks: Optional[int] = None         # push: total source blocks


class PageRankSession:
    """Stateful PageRank handle owning the graph state, the resolved engine
    and the ranks.  Construct via :meth:`from_graph` (streams and serving)
    or :meth:`from_snapshot` (solves over an existing snapshot)."""

    def __init__(self, *, hg: Optional[HostGraph] = None,
                 g: Optional[GraphSnapshot] = None,
                 config: Optional[EngineConfig] = None, r0=None,
                 device="cuda"):
        if config is None:
            config = EngineConfig()
        if not isinstance(config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got {type(config).__name__}"
                " — build one with repro_torch.api.config.EngineConfig(...)")
        if hg is None and g is None:
            raise ValueError("need a HostGraph (from_graph) or a "
                             "GraphSnapshot (from_snapshot)")
        self.config = config
        # a snapshot-mode session runs on its snapshot's device
        self.device = resolve_device(device if g is None else g.device)
        self.engine = registry.resolve(config.engine)
        self.engine_name = self.engine.name
        self.hg = hg
        self.g: Optional[GraphSnapshot] = None
        self._dtype = config.resolved_dtype()
        self._fault_plan = fault_domain.resolve_thread_plan(
            config.faults, config.fault_domain)
        self._stream = (self.engine_name == "pallas" and hg is not None
                        and g is None)
        # residual forward-push driver: a device-resident residual next to
        # the ranks, seeded in O(batch) per update
        self._push = config.driver == "push"
        if self._push and not self._stream:
            raise ValueError(
                "driver='push' runs the residual forward-push stream — "
                "open the session with from_graph and the pallas engine "
                "(from_snapshot has no operand mirrors to seed)")
        self._closed = False
        self._history: List[StreamBatchResult] = []
        self._warm_idx: Optional[int] = None
        self._queries = 0
        self._residual: Optional[torch.Tensor] = None
        # replay state for recompute("dt"/"df"): the last applied batch,
        # the pre-batch host graph / snapshot, and the pre-batch ranks
        self._last_batch: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._hg_prev: Optional[HostGraph] = None
        self._g_prev: Optional[GraphSnapshot] = None
        self._r_prev: Optional[torch.Tensor] = None
        # the last stream dt marking's BFS: (hops, host reads)
        self._dt_bfs: Optional[Tuple[int, int]] = None
        # seconds the last dt update or df/dt replay spent building its
        # two snapshots (host build and copy to the device)
        self._snap_s = 0.0
        if self._stream:
            self._init_stream(r0)
        else:
            self._init_snapshot(g, r0)

    @classmethod
    def from_graph(cls, hg: HostGraph, *,
                   config: Optional[EngineConfig] = None, r0=None,
                   device="cuda") -> "PageRankSession":
        """Open a session over a host graph on ``device``.  With the pallas
        engine this is stream mode; other engines run snapshot mode.
        ``r0=None`` runs one initial solve (``variant="static"``
        semantics) so the session is born serving."""
        return cls(hg=hg, config=config, r0=r0, device=device)

    @classmethod
    def from_snapshot(cls, g: GraphSnapshot, *,
                      config: Optional[EngineConfig] = None, r0=None,
                      hg: Optional[HostGraph] = None) -> "PageRankSession":
        """Wrap an existing snapshot (snapshot mode, on the snapshot's
        device; the block grid comes from the snapshot, not
        ``config.block_size``).  Pass ``hg`` as well to enable ``update``."""
        return cls(hg=hg, g=g, config=config, r0=r0)

    def _init_stream(self, r0) -> None:
        cfg = self.config
        dev, dt = self.device, self._dtype
        # the only snapshot the stream builds; not retained
        g0 = self.hg.snapshot(block_size=cfg.block_size, device=dev)
        self.n, self.n_pad = g0.n, g0.n_pad
        self.block_size, self.n_rb = g0.block_size, g0.n_blocks
        # runtime hyperparameter operands
        self._alpha = torch.tensor(cfg.alpha, dtype=dt, device=dev)
        self._tau = torch.tensor(cfg.tau, dtype=dt, device=dev)
        self._tau_f = torch.tensor(cfg.resolved_tau_f(expand=True),
                                   dtype=dt, device=dev)
        plan = self._fault_plan or flt.NO_FAULTS
        self._fault_tables = tuple(
            torch.as_tensor(a, device=dev)
            for a in plan.device_tables(cfg.max_iterations))

        self.inc = IncrementalPullMatrix.from_snapshot(g0, dtype=dt,
                                                       padded=True)
        self.valid = g0.vertex_valid
        # device-resident engine operands, patched in place per batch;
        # copies, never views of the host twins in inc.aux
        self._out_deg = g0.out_deg.clone()
        self._rb_in = torch.tensor(self.inc.aux.rb_in, device=dev)
        self._rb_out = torch.tensor(self.inc.aux.rb_out, device=dev)
        self._bmat = torch.tensor(self.inc.aux.bmat, device=dev)
        # host twin of the out-degree mirror, patched in O(batch): the push
        # seed divides by the sources' degrees before and after a batch
        self._out_deg_host = g0.out_deg.cpu().numpy().copy()
        if r0 is None and self._push:
            # cold push solve: p = 0, r = b — the invariant holds trivially
            # and the drive pushes the whole teleport mass to the fixed point
            self._residual = self._on_valid((1.0 - cfg.alpha) / self.n)
            r0, _, _, _ = self._drive_push(
                torch.zeros(self.n_pad, dtype=dt, device=dev))
        elif r0 is None:
            r0, _ = pe.run_pallas(
                g0, initial_ranks(g0, dt), g0.vertex_valid, mode=cfg.mode,
                expand=False, alpha=cfg.alpha, tau=cfg.tau,
                max_iterations=cfg.max_iterations,
                active_policy=cfg.active_policy,
                mat=self.inc.mat, aux=self.inc.aux)
        r0 = torch.as_tensor(r0, dtype=dt, device=dev)
        if r0.shape[0] < self.n_pad:        # length-n caller state
            r0 = torch.cat([r0, r0.new_zeros(self.n_pad - r0.shape[0])])
        self.R = r0[:self.n_pad]
        if self._push and self._residual is None:
            # caller-provided ranks: rebuild the exact residual invariant
            # before the first update seeds against it
            self._residual = self._residual_recompute(self.R)

    def _init_snapshot(self, g: Optional[GraphSnapshot], r0) -> None:
        cfg = self.config
        if g is None:
            g = self.hg.snapshot(block_size=cfg.block_size,
                                 device=self.device)
        self.g = g
        self.n, self.n_pad = g.n, g.n_pad
        self.block_size, self.n_rb = g.block_size, g.n_blocks
        self.valid = g.vertex_valid
        self.inc = None
        if r0 is None:
            self._converge(initial_ranks(g, self._dtype), g.vertex_valid,
                           expand=False)
        else:
            # keep the caller's dtype: the engines compute in R0's dtype
            self.R = pad_ranks(g, r0)

    # -- the snapshot-level solve --------------------------------------------
    def _converge(self, R0, affected0, *, expand: bool,
                  mode: Optional[str] = None, mat=None, aux=None,
                  g: Optional[GraphSnapshot] = None) -> PagerankResult:
        """Converge one (R0, affected0) problem through the resolved engine
        adapter and adopt the result as the session's ranks.  This is the
        exact path the deprecated ``*_pagerank`` functions shim onto."""
        cfg = self.config
        g = g if g is not None else self.g
        if g is None:
            raise ValueError("snapshot-level solve needs a GraphSnapshot "
                             "(stream-mode sessions use update/recompute)")
        t0 = time.perf_counter()
        R, stats = self.engine.run(
            g, R0, affected0, mode=mode or cfg.mode, expand=expand,
            alpha=cfg.alpha, tau=cfg.tau, tau_f=cfg.tau_f,
            max_iterations=cfg.max_iterations, faults=self._fault_plan,
            tile=cfg.tile, active_policy=cfg.active_policy,
            mat=mat, aux=aux, backend=cfg.backend)
        self.R = R
        return PagerankResult(ranks=R, stats=stats,
                              wall_time_s=time.perf_counter() - t0)

    # -- the fused solve -----------------------------------------------------
    def _drive(self, R0, affected, *, expand: bool, full: bool = False
               ) -> Tuple[torch.Tensor, SweepStats, int]:
        """Run the fused driver over the device-resident operand mirrors;
        returns (ranks, stats, host syncs made).  ``full``: every row-block
        is affected and stays so (see ``pallas_engine._driver``)."""
        cfg = self.config
        part, alive, delay, crashed = self._fault_tables
        R, sv, syncs = pe._driver(
            self.inc.mat, R0, affected, self.valid, self._out_deg,
            self._rb_in, self._rb_out, self._bmat,
            self._alpha, self._tau, self._tau_f,
            part, alive, delay, crashed,
            n=self.n, block_size=self.block_size, mode=cfg.mode,
            expand=expand, active_policy=cfg.active_policy,
            max_iterations=cfg.max_iterations, full=full)
        return R, pe._stats_from_vec(sv), syncs

    # -- the residual forward-push solve -------------------------------------
    def _on_valid(self, value: float) -> torch.Tensor:
        """``value`` on the valid vertices, 0 on the padding: the static
        start ``1/n`` and the teleport residual ``b = (1−α)/n`` of p = 0."""
        v = torch.tensor(value, dtype=self._dtype, device=self.device)
        return torch.where(self.valid, v, torch.zeros_like(v))

    def _drive_push(self, P0) -> Tuple[torch.Tensor, SweepStats, dict, int]:
        """One fused push drive over the device-resident operand mirrors:
        ranks + carried residual in, ranks + shrunk residual out; returns
        (ranks, stats, push extras, host syncs made)."""
        P, Rr, sv, syncs = pshe._push_driver(
            self.inc.mat, P0, self._residual, self.valid, self._out_deg,
            self._bmat, self._alpha, self._tau, n=self.n,
            block_size=self.block_size,
            max_iterations=self.config.max_iterations)
        self._residual = Rr
        stats, extras = pshe.push_stats_from_vec(sv)
        return P, stats, extras, syncs

    def _residual_recompute(self, P) -> torch.Tensor:
        """Exact O(m) residual rebuild ``r = b + M·p − p`` for the current
        graph (nd / given-ranks path): one launch of kernel #1."""
        return pshe.residual_full(self.inc.mat, P, self.valid, self._out_deg,
                                  self._alpha, n=self.n)

    def _seed_push(self, variant: str, sources: np.ndarray,
                   deg_old_src: np.ndarray) -> Tuple[torch.Tensor, int]:
        """Set the session residual for one applied batch and return
        ``(P0, host syncs made)``.  ``df`` is the O(batch·deg) path: the
        batch changes the pull matrix only in its effective source columns
        (``sources``, whose pre-batch degrees are ``deg_old_src``), so
        ``Δr = (M' − M)·p`` is enumerated on the host and applied by one
        deterministic device scatter; reading ``p`` at the sources is the
        one host sync.  ``nd`` keeps ``p`` and rebuilds the exact residual
        (O(m)); ``static`` restarts cold (p = 0, r = b)."""
        if variant == "df":
            syncs = 0
            if len(sources):
                p_src = self.R[ops._upload(sources, self.device)]
                p_src = p_src.cpu().numpy()
                syncs = 1
                sidx, svals = pshe.residual_seed_host(
                    self._hg_prev, self.hg, sources, p_src, deg_old_src,
                    self._out_deg_host[sources], float(self.config.alpha))
                self._residual = pshe.scatter_residual(self._residual, sidx,
                                                       svals)
            return self.R, syncs
        if variant == "nd":
            self._residual = self._residual_recompute(self.R)
            return self.R, 0
        self._residual = self._on_valid((1.0 - self.config.alpha) / self.n)
        return torch.zeros(self.n_pad, dtype=self._dtype,
                           device=self.device), 0

    def _solve(self, variant: str, affected=None, sources=None,
               deg_old_src=None) -> Tuple[torch.Tensor, SweepStats,
                                          Optional[dict], int]:
        """One solve of the current graph: the start state and active set
        of ``variant`` on the session's driver, then its drive.  Returns
        (ranks, stats, push extras or None, host syncs made).  ``df`` takes
        the seeded ``affected`` mask (pull) or the batch's effective
        ``sources`` and their pre-batch degrees (push); ``dt`` takes the
        reachability mask ``affected`` and starts warm without expansion;
        ``nd`` starts warm and ``static`` cold, with every vertex
        affected."""
        if self._push:
            P0, seed_syncs = self._seed_push(variant, sources, deg_old_src)
            R, stats, extras, syncs = self._drive_push(P0)
            return R, stats, extras, syncs + seed_syncs
        policy_affected = self.config.active_policy == "affected"
        checks = 0
        if variant in ("df", "dt"):
            R0, expand, full = self.R, variant == "df", False
            if variant == "dt" and policy_affected:
                # DT marks whatever the batch reaches — on a connected graph
                # every row-block, and then kernel #1 pulls (one read, as
                # run_pallas checks the same before its drive)
                full = bool(fr.block_any(affected & self.valid, self.n_rb,
                                         self.block_size).all())
                checks = 1
        else:
            affected, expand = self.valid, False
            R0 = self.R if variant == "nd" else self._on_valid(1.0 / self.n)
            # nd/static mark every vertex and never expand: all blocks active
            full = policy_affected
        R, stats, syncs = self._drive(R0, affected, expand=expand, full=full)
        return R, stats, None, syncs + checks

    def _update_stream(self, deletions, insertions, variant: str = "df"
                       ) -> StreamBatchResult:
        """Stream step: operand-mirror patch → DF seed over G^{t-1} → tile
        scatter → DF seed over G^t → fused convergence loop.  On a push
        session the residual seed replaces both DF seed passes; ``dt``
        marks by a BFS over snapshots of G^{t-1} and G^t instead."""
        if variant == "dt" and self._push:
            raise ValueError(
                "driver='push' does not implement the dt reachability "
                "marking (it walks throwaway snapshots of the pull "
                "iterate); use variant='df' or 'nd', or a driver='pull' "
                "session")
        t0 = time.perf_counter()
        builds0 = nvcc.total_builds()
        dev, B = self.device, self.block_size
        self._snap_s = 0.0
        g_prev_snap = self._snapshot(self.hg) if variant == "dt" else None
        dels_eff, ins_eff = effective_batch(self.hg, deletions, insertions)
        rows, cols, vals = signed_edge_delta(dels_eff, ins_eff)
        affected = sources = deg_old_src = None
        if self._push:
            # the push seed divides by the PRE-batch degrees of the
            # effective sources: read them before the mirror patch
            sources = np.unique(np.concatenate([dels_eff[:, 0],
                                                ins_eff[:, 0]]))
            deg_old_src = self._out_deg_host[sources]
        if len(rows):
            np.add.at(self._out_deg_host, cols,
                      vals.astype(self._out_deg_host.dtype))
            _apply_operand_delta(
                self._out_deg, self._rb_in, self._rb_out, self._bmat,
                torch.as_tensor(rows, device=dev),
                torch.as_tensor(cols, device=dev),
                torch.as_tensor(vals.astype(np.int32), device=dev),
                block=B)
        seed = h_prev = None
        if variant == "df" and not self._push:
            batch_dev = fr.pack_batch(self.n_pad, deletions, insertions,
                                      device=dev)
            seed = _seed_sources(self._bmat, batch_dev, self.valid,
                                 block_size=B)
            h_prev = _seed_pass(self.inc.mat, seed)     # G^{t-1}
        self.inc.advance(self.hg, None, deletions, insertions,
                         effective=(dels_eff, ins_eff))
        # the push seed walks both key sets; the df/dt replay needs both
        self._hg_prev, self._r_prev = self.hg, self.R
        self._last_batch = (np.asarray(deletions, np.int64).reshape(-1, 2),
                            np.asarray(insertions, np.int64).reshape(-1, 2))
        self.hg = self.hg.apply_batch(deletions, insertions)
        raw = (np.asarray(deletions).reshape(-1, 2).shape[0]
               + np.asarray(insertions).reshape(-1, 2).shape[0])

        dt_syncs = 0
        if variant == "df" and not self._push:
            hit = h_prev | _seed_pass(self.inc.mat, seed)       # ∪ G^t
            affected = _seed_mask(hit, seed, self.valid, block_size=B)
        elif variant == "dt":
            g_new_snap = self._snapshot(self.hg)
            affected, hops, dt_syncs = fr._dt_reach(
                g_prev_snap, g_new_snap,
                fr.batch_to_device(g_new_snap, deletions, insertions))
            self._dt_bfs = (hops, dt_syncs)
        R, stats, extras, syncs = self._solve(variant, affected, sources,
                                              deg_old_src)
        self.R = R
        return StreamBatchResult(
            ranks=R, stats=stats, wall_time_s=time.perf_counter() - t0,
            batch_edges=raw, driver_retraces=nvcc.total_builds() - builds0,
            host_syncs=syncs + dt_syncs,
            residual_mass=None if extras is None else extras["residual_l1"],
            pushed_blocks=None if extras is None else extras["pushed_blocks"])

    def _snapshot(self, hg: HostGraph) -> GraphSnapshot:
        """Snapshot of ``hg`` on the session's device; its seconds add to
        ``_snap_s``."""
        t0 = time.perf_counter()
        g = hg.snapshot(block_size=self.block_size, device=self.device)
        self._snap_s += time.perf_counter() - t0
        return g

    def _update_snapshot(self, deletions, insertions, variant: str
                         ) -> StreamBatchResult:
        """Snapshot-mode step: rebuild the snapshot (O(m) host work — the
        legacy path, kept for the oracle engines) and converge through the
        engine adapter."""
        t0 = time.perf_counter()
        builds0 = nvcc.total_builds()
        g_prev = self.g
        hg_new = self.hg.apply_batch(deletions, insertions)
        g_new = hg_new.snapshot(block_size=self.block_size,
                                device=self.device)
        batch_dev = fr.batch_to_device(g_new, deletions, insertions)
        if variant == "df":
            affected = fr.initial_affected(g_prev, g_new, batch_dev)
            R0, expand = pad_ranks(g_new, self.R), True
        elif variant == "dt":
            affected = fr.dt_affected(g_prev, g_new, batch_dev)
            R0, expand = pad_ranks(g_new, self.R), False
        elif variant == "nd":
            affected, expand = g_new.vertex_valid, False
            R0 = pad_ranks(g_new, self.R)
        else:   # static
            affected, expand = g_new.vertex_valid, False
            R0 = initial_ranks(g_new, self._dtype)
        self._hg_prev, self._g_prev = self.hg, g_prev
        self._last_batch = (np.asarray(deletions, np.int64).reshape(-1, 2),
                            np.asarray(insertions, np.int64).reshape(-1, 2))
        self._r_prev = self.R
        self.hg, self.g = hg_new, g_new
        self.n, self.n_pad = g_new.n, g_new.n_pad
        self.valid = g_new.vertex_valid
        res = self._converge(R0, affected, expand=expand, g=g_new)
        raw = (np.asarray(deletions).reshape(-1, 2).shape[0]
               + np.asarray(insertions).reshape(-1, 2).shape[0])
        return StreamBatchResult(
            ranks=res.ranks, stats=res.stats,
            wall_time_s=time.perf_counter() - t0, batch_edges=raw,
            driver_retraces=nvcc.total_builds() - builds0)

    # -- updates -------------------------------------------------------------
    def update(self, deletions, insertions, *, variant: str = "df"
               ) -> StreamBatchResult:
        """Apply one edge batch and reconverge.  ``variant``: ``"df"``
        (Dynamic Frontier, the paper's algorithm; on a push session the
        O(batch) residual seed), ``"dt"`` (reachability marking; a push
        session raises ``ValueError``), ``"nd"`` (warm start, all affected)
        or ``"static"`` (cold start, all affected)."""
        self._ensure_open()
        if variant not in VARIANTS:
            raise ValueError(f"variant={variant!r} invalid; "
                             f"expected one of {VARIANTS}")
        if self.hg is None:
            raise ValueError(
                "this session wraps a bare snapshot (from_snapshot without "
                "hg=); build it with PageRankSession.from_graph to stream "
                "updates")
        deletions, insertions = validate_edge_batch(deletions, insertions,
                                                    self.n)
        if self._stream:
            res = self._update_stream(deletions, insertions, variant)
        else:
            res = self._update_snapshot(deletions, insertions, variant)
        self._history.append(res)
        if not res.stats.converged:
            warnings.warn(
                f"update batch {len(self._history)} hit the sweep cap "
                f"(max_iterations={self.config.max_iterations}) without "
                f"reaching tau={self.config.tau} — serving the best iterate",
                SweepCapWarning, stacklevel=2)
        return res

    # -- recompute -----------------------------------------------------------
    def recompute(self, variant: str = "static") -> PagerankResult:
        """Re-solve the session's **current** graph.

        ``"static"`` starts from uniform ranks, ``"nd"`` warm from the
        session's ranks (both with every vertex affected; a push session
        rebuilds its residual exactly).  ``"dt"`` / ``"df"`` *replay the
        last update batch* with that variant's marking from the pre-batch
        ranks — the what-if tool for comparing variants on one step; they
        need a prior ``update`` and have no push analogue."""
        self._ensure_open()
        if variant not in VARIANTS:
            raise ValueError(f"variant={variant!r} invalid; "
                             f"expected one of {VARIANTS}")
        if variant in ("df", "dt") and self._push:
            raise ValueError(
                f"recompute({variant!r}) replays the pull driver's "
                "frontier marking; a driver='push' session re-solves via "
                "variant='static' or 'nd'")
        if variant in ("static", "nd"):
            if self._stream:
                t0 = time.perf_counter()
                R, stats, _, _ = self._solve(variant)
                self.R = R
                return PagerankResult(ranks=R, stats=stats,
                                      wall_time_s=time.perf_counter() - t0)
            R0 = self.R if variant == "nd" else self._on_valid(1.0 / self.n)
            return self._converge(R0, self.valid, expand=False)

        # dt / df: replay the last batch's marking from the pre-batch state
        if self._last_batch is None:
            raise ValueError(
                f"recompute({variant!r}) replays the last update batch, but "
                "no batch has been applied yet — call update() first or use "
                "variant='static'/'nd'")
        self._snap_s = 0.0
        g_prev = (self._g_prev if self._g_prev is not None
                  else self._snapshot(self._hg_prev))
        g_cur = self.g if self.g is not None else self._snapshot(self.hg)
        batch_dev = fr.batch_to_device(g_cur, *self._last_batch)
        if variant == "df":
            affected = fr.initial_affected(g_prev, g_cur, batch_dev)
        else:
            affected = fr.dt_affected(g_prev, g_cur, batch_dev)
        R0 = pad_ranks(g_cur, self._r_prev)
        mat = aux = None
        if self._stream:
            # reuse the incrementally maintained operands
            mat, aux = self.inc.mat, self.inc.aux
        return self._converge(R0, affected, expand=(variant == "df"),
                              g=g_cur, mat=mat, aux=aux)

    # -- serving reads -------------------------------------------------------
    def _vertex_ids(self, vertices) -> np.ndarray:
        arr = np.asarray(vertices)
        if arr.size == 0:
            return np.zeros(0, np.int64)
        if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"vertex ids must be integers, got dtype {arr.dtype} "
                f"(value: {vertices!r})")
        idx = arr.reshape(-1).astype(np.int64)
        bad = (idx < 0) | (idx >= self.n)
        if bad.any():
            raise ValueError(
                f"vertex id(s) {idx[bad][:8].tolist()} out of range for a "
                f"graph with {self.n} vertices (valid ids: 0..{self.n - 1})")
        return idx

    def query(self, vertices: Union[int, Sequence[int], np.ndarray]
              ) -> np.ndarray:
        """Ranks of the given vertices: one device gather, only
        ``len(vertices)`` values cross to the host."""
        self._ensure_open()
        idx = self._vertex_ids(vertices)
        vals = self.R[torch.as_tensor(idx, device=self.device)]
        self._queries += int(idx.shape[0])
        return vals.cpu().numpy()

    def top_k(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(values, vertex ids) of the k highest-ranked vertices, computed on
        the device (ties: lower id first, as ``lax.top_k``)."""
        self._ensure_open()
        if not isinstance(k, (int, np.integer)):
            raise ValueError(
                f"k must be an integer, got {type(k).__name__} ({k!r})")
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        k = int(min(k, self.n))
        masked = torch.where(self.valid, self.R, -torch.inf)
        vals, idx = torch.sort(masked, descending=True, stable=True)
        self._queries += k
        return vals[:k].cpu().numpy(), idx[:k].cpu().numpy()

    @property
    def ranks(self) -> np.ndarray:
        """Full host copy of the rank vector (prefer :meth:`query` /
        :meth:`top_k` for serving)."""
        self._ensure_open()
        return self.R.cpu().numpy()

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def _ensure_open(self) -> None:
        if self._closed:
            raise ValueError("session is closed — open a new "
                             "PageRankSession")

    def close(self) -> None:
        """End the session and drop every device buffer reference.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        for attr in ("R", "inc", "g", "valid", "_out_deg", "_rb_in",
                     "_rb_out", "_bmat", "_fault_tables", "_residual",
                     "_out_deg_host", "_hg_prev", "_g_prev", "_r_prev"):
            setattr(self, attr, None)

    def __enter__(self) -> "PageRankSession":
        self._ensure_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- warmup / reporting --------------------------------------------------
    def warmup(self) -> None:
        """Run the per-batch pipeline once without perturbing graph or rank
        state — a zero-value delta on vertex 0's self-loop tile, on a push
        session a residual scatter of one zero (its result dropped), and an
        empty-batch step — so the kernel library is built and loaded and the
        allocator holds the step's buffers before the first real update.
        Snapshot-mode sessions are already warm from their initial solve."""
        self._ensure_open()
        if self._stream:
            z = np.zeros(1, np.int64)
            self.inc.mat = ops.apply_delta(self.inc.mat, z, z, np.zeros(1))
            if self._push:
                pshe.scatter_residual(self._residual, z, np.zeros(1))
            empty = np.zeros((0, 2), np.int64)
            # the dt/df replay state must not see the empty warmup batch as
            # "the last update"
            saved = (self._last_batch, self._hg_prev, self._r_prev)
            self._update_stream(empty, empty)
            self._last_batch, self._hg_prev, self._r_prev = saved
        self._warm_idx = len(self._history)

    def report(self) -> SessionReport:
        """Latency / work statistics over the update history.
        ``retraces_post_warmup`` counts kernel builds during updates after
        :meth:`warmup` (or after the first update without one)."""
        hist = self._history
        walls = [r.wall_time_s for r in hist]
        start = self._warm_idx if self._warm_idx is not None else 1
        dev_bytes = self._device_bytes()
        return SessionReport(
            engine=self.engine_name, device=str(self.device),
            mode=self.config.mode, n_updates=len(hist),
            p50_s=float(np.percentile(walls, 50)) if walls else 0.0,
            p95_s=float(np.percentile(walls, 95)) if walls else 0.0,
            retraces_post_warmup=sum(r.driver_retraces
                                     for r in hist[start:]),
            total_sweeps=sum(r.stats.sweeps for r in hist),
            total_edges_processed=sum(r.stats.edges_processed
                                      for r in hist),
            queries_served=self._queries, wall_times_s=walls,
            batches_converged=sum(1 for r in hist if r.stats.converged),
            sweep_cap_hits=sum(1 for r in hist if not r.stats.converged),
            device_bytes=dev_bytes,
            bytes_per_vertex=(sum(dev_bytes.values()) / max(self.n, 1)
                              if dev_bytes is not None else None),
            sweeps_history=[int(r.stats.sweeps) for r in hist],
            edges_processed_history=[int(r.stats.edges_processed)
                                     for r in hist],
            host_syncs_history=[int(r.host_syncs) for r in hist],
            driver=self.config.driver,
            residual_mass_last=next((r.residual_mass for r in reversed(hist)
                                     if r.residual_mass is not None), None),
            pushed_blocks=(sum(r.pushed_blocks for r in hist)
                           if self._push and hist else None))

    def _device_bytes(self) -> Optional[dict]:
        """Per-component device-resident bytes (the memory audit)."""
        if self._closed:
            return None
        if self.inc is None:
            g = self.g
            return {
                "ranks": self.R.nbytes + self.valid.nbytes,
                "graph_snapshot": sum(
                    getattr(g, f.name).nbytes for f in dataclasses.fields(g)
                    if isinstance(getattr(g, f.name), torch.Tensor)),
            }
        mat = self.inc.mat
        return {
            "ranks": self.R.nbytes + self.valid.nbytes,
            "tile_pool": mat.tiles.nbytes,
            "packed_index": mat.index.nbytes,
            "slot_tables": mat.tile_cols.nbytes + mat.tile_idx.nbytes,
            "operand_mirrors": (self._out_deg.nbytes + self._rb_in.nbytes
                                + self._rb_out.nbytes + self._bmat.nbytes),
            "residual": (self._residual.nbytes if self._residual is not None
                         else 0),
        }
