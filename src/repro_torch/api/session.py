"""`PageRankSession` — one stateful handle for streams and snapshots.

Ports the single-device stream and snapshot modes of
``src/repro/api/session.py``, tiered storage under both drivers
included: ``_seed_affected``, ``_apply_operand_delta``, ``_admit``,
``_mask_from_indices``, ``_drive_refill``, ``from_graph``,
``from_snapshot``, ``_init_stream``, ``_init_snapshot``, ``_converge``,
``_drive``, ``_drive_push``, ``_drive_push_refill``,
``_residual_recompute``,
``_seed_push``, ``_update_stream``, ``_update_snapshot``, ``update`` (all
four variants), ``recompute`` (``static``/``nd``, and the ``df``/``dt``
replay of the last batch), ``query``, ``top_k``, ``ranks``, ``warmup``,
``close`` and ``report``, the durability of the process fault domain
(``save``, ``restore``, ``fork`` and ``device_footprint``) and the
corruption fault domain (``verify`` with its repair ladder,
``inject_corruption``, the fused invariant check of every drive,
``report().integrity``), the hooks a
:class:`~repro_torch.api.service.PageRankService` uses (the ``_service``
backref ``close`` unregisters through, and :class:`ReadView`, the
ranks-only copy degraded reads are served from), and the walk mode
(``_init_walk``, ``_update_walk``, ``_recompute_walk``, ``ppr_query``)::

    from repro_torch.api.session import PageRankSession
    from repro_torch.api.config import EngineConfig

    sess = PageRankSession.from_graph(hg, config=EngineConfig(tau=1e-10))
    sess.update(dels, ins)          # DF_LF step on the card
    sess.query([3, 17, 42])         # device gather, only the values move
    sess.top_k(10)

    push = PageRankSession.from_graph(
        hg, config=EngineConfig(tau=1e-10, driver="push"))
    push.update(dels, ins)          # residual seed + forward push

    durable = PageRankSession.from_graph(
        hg, config=EngineConfig(durability="wal"), store_dir="store/")
    durable.update(dels, ins)       # WAL append (fsync'd), then the step
    again = PageRankSession.restore("store/")   # checkpoint + WAL replay

    checked = PageRankSession.from_graph(
        hg, config=EngineConfig(integrity=IntegrityConfig(auto_repair=False)))
    checked.inject_corruption("tile", seed=3)   # silent damage
    checked.verify(repair=True)     # detect, then frontier/rebuild/restore

    walks = PageRankSession.from_graph(
        hg, config=EngineConfig(engine="walk", walks_per_vertex=16))
    walks.update(dels, ins)         # regenerate the walks the batch touches
    walks.ppr_query([3, 17], k=10)  # personalized top-k from the seeds' walks

Three modes, picked at construction:

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
* **walk mode** (``EngineConfig(engine="walk")``): no sweeps; the session
  owns a :class:`~repro_torch.core.walk_engine.WalkState` (R walk segments
  per vertex on the device), regenerates only the walks a batch touches
  (``walk_touch`` finds them, ``walk_regen`` rebuilds them), serves the
  global estimate as its ranks and ``ppr_query`` from the seeds' walks.
  Its walks, counts and reads equal the reference's bit for bit; a WAL
  replay regenerates them exactly.  It hosts the process fault domain
  only: ``verify`` and ``inject_corruption`` raise.

One ordering differs from the reference, because the port patches the tile
pool and its packed index in place: the DF seed's OR pass over G^{t-1} runs
*before* the tile scatter and index refresh, on the same stream, and its
pass over G^t after them (the JAX session keeps both pools and runs both
passes after the scatter).  The marking is the same.

Durability follows the reference (``EngineConfig(durability="wal")`` with
``store_dir=``): each batch is validated, appended to the store's WAL and
only then applied; a failure inside the apply truncates its record away;
every ``checkpoint_interval`` batches, and after a ``recompute``, the ranks
and the edge set are checkpointed.  ``restore`` rebuilds the session from
the newest valid checkpoint (a fresh pool and packed index from the stored
edges, the stored ranks as ``r0``: no solve) and replays the WAL through
``update``.  ``fork`` cannot share the pool as the reference's immutable
arrays do, because the port patches it in place: a fork copies every device
tensor a later update writes.

Tiered storage (``EngineConfig(device_budget_bytes=N)``, either driver):
the whole tile pool stays on the host
(:class:`~repro_torch.core.tiering.HostTilePool`) and the card holds a
budget-bounded slab of packed entries
(:class:`~repro_torch.core.tiering.HotSetManager`).  An update patches
host truth, drops the touched blocks from the slab, seeds on the host (the
pull's DF seed ``df_seed_indices``, or the push's residual seed), admits
the touched and seed blocks and their candidates, and drives through a
refill loop.  The pull's re-drives the blocks the driver deferred until
the reference's quiet-window criterion drains them; the push's admits the
blocks its pushes could not reach, rebuilds their residual exactly and
re-drives until none is deferred, and a tiered push session rebuilds a
whole residual from host truth.  ``save`` reads host truth; a restore
starts from an empty slab, so a WAL replay re-drives along another
residency path than the live session took, as the reference's does.

Integrity (``EngineConfig(integrity=...)``, pull driver) follows the
reference's checks and ladder over the state the card computes from: the
sum check and the ``tile`` corruption cover the packed index the kernels
read as well as the dense pool, a port check (``packed_index``) holds the
index to the pool it was packed from, and the drift baseline
``_r_verified`` is a copy whenever ``integrity=`` is set, because the port
writes some rank vectors in place.  A tiered session's checks read host
truth and CRC the slab.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api import registry
from repro_torch.api.config import EngineConfig
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core import distributed as dist
from repro_torch.core import fault_domain
from repro_torch.core import faults as flt
from repro_torch.core import frontier as fr
from repro_torch.core import integrity as ig
from repro_torch.core import pallas_engine as pe
from repro_torch.core import push_engine as pshe
from repro_torch.core import tiering
from repro_torch.core import walk_engine as we
from repro_torch.core.blocked import SweepStats
from repro_torch.core.delta import signed_edge_delta, validate_edge_batch
from repro_torch.core.graph import (GraphSnapshot, HostGraph,
                                    initial_ranks, pad_ranks)
from repro_torch.core.incremental import (IncrementalPullMatrix,
                                          MatrixAux, effective_batch)
from repro_torch.core.pagerank import PagerankResult
from repro_torch.device import as_torch_dtype, resolve_device
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


def _add_drive(agg: SweepStats, st: SweepStats) -> SweepStats:
    """A refill round's drive added to the drives before it: the counters
    sum, ``converged`` is the last drive's, ``dnf`` sticks."""
    return SweepStats(
        sweeps=agg.sweeps + st.sweeps,
        iterations=agg.iterations + st.iterations,
        blocks_processed=agg.blocks_processed + st.blocks_processed,
        edges_processed=agg.edges_processed + st.edges_processed,
        sim_time_ms=agg.sim_time_ms + st.sim_time_ms,
        converged=bool(st.converged), dnf=bool(agg.dnf or st.dnf))


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


def _entry_of(index: ops.PackedIndex, key: int, bi: int, bj: int) -> int:
    """Position in ``index`` of the stored entry (``bi``, ``bj``) of tile
    (or slab slot) ``key``."""
    off, cnt = int(index.off[key]), int(index.cnt[key])
    hit = ((index.row[off:off + cnt] == bi)
           & (index.col[off:off + cnt] == bj)).nonzero()
    if len(hit) != 1:
        raise ValueError(f"entry ({bi}, {bj}) of tile {key} is not in the "
                         "packed index")
    return off + int(hit[0, 0])


def _vertex_ids(vertices, n: int) -> np.ndarray:
    """Validated int64 vertex ids of a read (the reference's errors)."""
    arr = np.asarray(vertices)
    if arr.size == 0:
        return np.zeros(0, np.int64)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"vertex ids must be integers, got dtype {arr.dtype} "
            f"(value: {vertices!r})")
    idx = arr.reshape(-1).astype(np.int64)
    bad = (idx < 0) | (idx >= n)
    if bad.any():
        raise ValueError(
            f"vertex id(s) {idx[bad][:8].tolist()} out of range for a "
            f"graph with {n} vertices (valid ids: 0..{n - 1})")
    return idx


def _top_k_count(k, n: int) -> int:
    if not isinstance(k, (int, np.integer)):
        raise ValueError(
            f"k must be an integer, got {type(k).__name__} ({k!r})")
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    return int(min(k, n))


def _gather(R: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    return R[torch.as_tensor(idx, device=R.device)].cpu().numpy()


def _top_k(R: torch.Tensor, valid: torch.Tensor, k: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    # a stable descending sort: ties lower id first, as lax.top_k
    masked = torch.where(valid, R, -torch.inf)
    vals, idx = torch.sort(masked, descending=True, stable=True)
    return vals[:k].cpu().numpy(), idx[:k].cpu().numpy()


def _ppr_args(seeds, k, n: int) -> Tuple[np.ndarray, int]:
    """Validated ``(seeds, k)`` of a ``ppr_query`` (the reference's
    errors)."""
    seeds = _vertex_ids(seeds, n)
    if seeds.size == 0:
        raise ValueError("ppr_query needs at least one seed vertex "
                         "(got an empty seed set)")
    return seeds, _top_k_count(k, n)


def _no_ppr(engine) -> registry.CapabilityError:
    return registry.CapabilityError(
        f"ppr_query needs an engine declaring the 'ppr' capability; "
        f"engine {engine.name!r} declares supports="
        f"{sorted(registry.supports_of(engine))} — open the "
        "session with EngineConfig(engine='walk')")


class ReadView:
    """What a degraded read needs of a session and nothing more: clones of
    the ranks and the valid mask, ``n``, and the batch index they hold, and
    for a walk session a clone of its walk buffer (``ppr_query``; 3.22 GB
    at n = 1M, R = 16, L = 48).

    The reference serves degraded reads from a ``fork()``, which shares
    JAX's immutable arrays.  The port's fork copies every tensor an update
    writes (at n = 1M about one more tile pool), so a service refreshing
    its read replica after every dispatch keeps this view instead (at
    n = 1M 9 MB).  The clones are the view's own: an update writing the
    ranks in place, a ``rank`` corruption of the live copy, or ``close()``
    leave it as it was.  On a card the clones are taken on the caller's
    current stream and ``ready`` is recorded after them; a read on another
    stream waits on it before it gathers.  ``query``, ``top_k`` and
    ``ppr_query`` give the session's values, ids, tie order and errors."""

    __slots__ = ("R", "valid", "n", "batch_index", "device", "ready",
                 "engine", "walks", "_walk_args")

    def __init__(self, sess: "PageRankSession"):
        self.R = sess.R.clone()
        self.valid = sess.valid.clone()
        self.n = sess.n
        self.batch_index = sess._batch_index
        self.device = sess.device
        self.engine = sess.engine
        self.walks = None
        self._walk_args = None
        if sess._walk:
            ws = sess.walks
            self.walks = ws.walks.clone()
            self._walk_args = dict(n=ws.n, R=ws.R, alpha32=ws._alpha32,
                                   dtype=ws.dtype)
        self.ready = None
        if self.R.is_cuda:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(self.R.device))

    @property
    def nbytes(self) -> int:
        return (self.R.nbytes + self.valid.nbytes
                + (self.walks.nbytes if self.walks is not None else 0))

    def _wait(self) -> None:
        if self.ready is not None:
            torch.cuda.current_stream(self.R.device).wait_event(self.ready)

    def query(self, vertices) -> np.ndarray:
        idx = _vertex_ids(vertices, self.n)
        self._wait()
        return _gather(self.R, idx)

    def top_k(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        k = _top_k_count(k, self.n)
        self._wait()
        return _top_k(self.R, self.valid, k)

    def ppr_query(self, seeds, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.walks is None:
            raise _no_ppr(self.engine)
        seeds, k = _ppr_args(seeds, k, self.n)
        self._wait()
        vals = we.ppr_values(self.walks, torch.as_tensor(
            seeds, device=self.walks.device), **self._walk_args)
        v, i = we.top_k(vals, k)
        return v.cpu().numpy(), i.cpu().numpy()


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
    # -- walk-mode localization accounting (None on sweep engines) ----------
    regenerated_walks: Optional[int] = None   # walks rebuilt this batch
    touched_walks: Optional[int] = None       # touched-walk mass (bound)
    total_walks: Optional[int] = None         # n * R (the "global" yardstick)

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
    # -- fault domains / durability ------------------------------------------
    durability: str = "none"
    recoveries: int = 0                       # completed, any domain
    recovery_time_s: float = 0.0              # summed detection→recovered
    replayed_batches: int = 0                 # WAL batches replayed (process)
    recovery_events: List[dict] = dataclasses.field(default_factory=list)
    device_bytes: Optional[dict] = None
    bytes_per_vertex: Optional[float] = None
    driver: str = "pull"
    sweeps_history: List[int] = dataclasses.field(default_factory=list)
    edges_processed_history: List[int] = dataclasses.field(
        default_factory=list)
    host_syncs_history: List[int] = dataclasses.field(default_factory=list)
    residual_mass_last: Optional[float] = None  # push: ‖r‖₁ at last exit
    pushed_blocks: Optional[int] = None         # push: total source blocks
    tiering: Optional[dict] = None              # HotSetManager counters
    integrity: Optional[dict] = None            # checks, detections, rungs


class PageRankSession:
    """Stateful PageRank handle owning the graph state, the resolved engine
    and the ranks.  Construct via :meth:`from_graph` (streams and serving)
    or :meth:`from_snapshot` (solves over an existing snapshot), or reopen
    a durable one with :meth:`restore`."""

    def __init__(self, *, hg: Optional[HostGraph] = None,
                 g: Optional[GraphSnapshot] = None,
                 config: Optional[EngineConfig] = None, r0=None,
                 device="cuda", store_dir: Optional[str] = None,
                 _restore_attach: bool = False):
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
        # walk mode: an engine declaring "ppr" (the walk engine) keeps a
        # WalkState and serves personalized reads
        self._walk = "ppr" in registry.supports_of(self.engine)
        self.walks: Optional[we.WalkState] = None
        # tiered storage: host-truth tile pool + a budget-bounded device hot
        # slab; stream mode only
        self._tiered = config.device_budget_bytes is not None
        if self._tiered and not self._stream:
            raise ValueError(
                "device_budget_bytes tiers the streaming tile pool — open "
                "the session with from_graph and the pallas engine")
        self.pool: Optional[tiering.HostTilePool] = None
        self.hot: Optional[tiering.HotSetManager] = None
        self._deferred_rb: Optional[np.ndarray] = None
        # residual forward-push driver: a device-resident residual next to
        # the ranks, seeded in O(batch) per update
        self._push = config.driver == "push"
        if self._push and not self._stream:
            raise ValueError(
                "driver='push' runs the residual forward-push stream — "
                "open the session with from_graph and the pallas engine "
                "(from_snapshot has no operand mirrors to seed)")
        self._closed = False
        self._service = None          # backref set by PageRankService
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
        # -- durability / the process fault domain ---------------------------
        self._recoveries: List[fault_domain.RecoveryRecord] = []
        self._batch_index = 0       # update batches applied (the WAL key)
        self._replaying = False     # True while restore() replays the WAL
        self.store_dir = store_dir
        self.store: Optional[SessionStore] = None
        self._process_domain: Optional[fault_domain.ProcessFaultDomain] = None
        if config.durability == "wal":
            if hg is None:
                raise ValueError(
                    "durability='wal' needs a host graph (from_graph, or "
                    "from_snapshot with hg=) — the WAL replays edge "
                    "batches against it")
            if store_dir is None:
                raise ValueError(
                    "durability='wal' needs a store_dir= (the directory "
                    "holding the checkpoint + WAL)")
            self.store = SessionStore(store_dir)
            if not _restore_attach and (
                    self.store.read_meta() is not None
                    or self.store.latest_checkpoint_index is not None):
                raise ValueError(
                    f"store_dir {store_dir!r} already holds a session — "
                    "reopen it with PageRankSession.restore(dir) (replays "
                    "its WAL), or give a new session a fresh directory; "
                    "mixing two sessions' logs would corrupt both")
            self._process_domain = fault_domain.ProcessFaultDomain(
                self.store, checkpoint_interval=config.checkpoint_interval)
        # -- the corruption domain (core/integrity.py) -----------------------
        self._corruption_faults: Optional[
            fault_domain.CorruptionFaultDomain] = None
        if isinstance(config.fault_domain,
                      fault_domain.CorruptionFaultDomain):
            config.fault_domain.validate_for(topology=config.topology)
            # each session consumes a private clone of the schedule riding
            # the shareable frozen config
            self._corruption_faults = config.fault_domain.clone()
        self._integrity_checks = 0      # invariant/digest checks evaluated
        self._corruption_detected = 0   # verify() passes that found damage
        self._integrity_alert: Optional[dict] = None  # fused-drive detection
        self._scatter_fault: Optional[str] = None     # pending torn scatter
        # the last integrity-clean iterate: always a copy, never a tensor
        # something writes in place (the drift check would read 0)
        self._r_verified: Optional[torch.Tensor] = None
        self._hg_digest: Optional[int] = None
        if self._walk:
            self._init_walk(g)
        elif self._stream:
            self._init_stream(r0)
        else:
            self._init_snapshot(g, r0)
        # durable bootstrap: a fresh store gets the meta and a checkpoint of
        # the born state (batch 0), so a crash before the first update
        # already restores; restore() attaches to a populated store
        if (self.store is not None
                and self.store.latest_checkpoint_index is None):
            self._checkpoint_now()

    @classmethod
    def from_graph(cls, hg: HostGraph, *,
                   config: Optional[EngineConfig] = None, r0=None,
                   device="cuda", store_dir: Optional[str] = None
                   ) -> "PageRankSession":
        """Open a session over a host graph on ``device``.  With the pallas
        engine this is stream mode, with the walk engine walk mode; other
        engines run snapshot mode.
        ``r0=None`` runs one initial solve (``variant="static"``
        semantics) so the session is born serving.  ``store_dir`` is the
        store a ``config.durability="wal"`` session checkpoints and logs
        through."""
        return cls(hg=hg, config=config, r0=r0, device=device,
                   store_dir=store_dir)

    @classmethod
    def from_snapshot(cls, g: GraphSnapshot, *,
                      config: Optional[EngineConfig] = None, r0=None,
                      hg: Optional[HostGraph] = None,
                      store_dir: Optional[str] = None) -> "PageRankSession":
        """Wrap an existing snapshot (snapshot mode, on the snapshot's
        device; the block grid comes from the snapshot, not
        ``config.block_size``).  Pass ``hg`` as well to enable ``update``
        (and a durable store)."""
        return cls(hg=hg, g=g, config=config, r0=r0, store_dir=store_dir)

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

        self.valid = g0.vertex_valid
        self._build_operands(g0)
        self._hg_digest = self._graph_digest()
        if r0 is None and self._push:
            # cold push solve: p = 0, r = b — the invariant holds trivially
            # and the drive pushes the whole teleport mass to the fixed point
            # (a tiered session through the refill loop, every block wanted)
            self._residual = self._on_valid((1.0 - cfg.alpha) / self.n)
            r0, _, _, _ = self._drive_push_refill(
                torch.zeros(self.n_pad, dtype=dt, device=dev),
                want_rb=np.arange(self.n_rb) if self._tiered else None)
        elif r0 is None and self._tiered:
            # cold solve through the refill loop: admit what fits, converge
            # the resident blocks, defer the rest (block-Jacobi over
            # residency partitions; expansion carries corrections across
            # rounds)
            r0, _, _ = self._drive_refill(
                initial_ranks(g0, dt), g0.vertex_valid,
                want_rb=np.arange(self.n_rb))
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
        self._set_baseline(self.R)          # drift baseline of the checks
        if self._push and self._residual is None:
            # caller-provided ranks: rebuild the exact residual invariant
            # before the first update seeds against it
            self._residual = self._residual_recompute(self.R)

    def _build_operands(self, g0: GraphSnapshot) -> None:
        """The stream's matrix and engine operands from a snapshot of the
        host graph: the pull matrix with its packed index (a tiered session:
        the host pool and an empty hot slab), the per-block host twins, the
        device operand mirrors and the out-degree's host twin.  The session
        opens with it and the ``rebuild`` repair rung re-derives with it."""
        cfg, dev, dt = self.config, self.device, self._dtype
        if self._tiered:
            # host tier: the full tile pool and slot tables stay on the
            # host; only the hot set's packed slab is on the device, and
            # the device matrix is its view, rebound after every admission
            src, dst = g0.in_edges_host()
            self.pool = tiering.HostTilePool.from_edges(
                dst, src, g0.n_pad, g0.n_pad, block=g0.block_size, dtype=dt)
            self.hot = tiering.HotSetManager(
                self.pool, cfg.device_budget_bytes, device=dev)
            aux = MatrixAux(
                bmat=tiering.host_block_adjacency(self.pool.tile_cols,
                                                  self.pool.mat.n_cb),
                rb_in=g0.block_in_edges().cpu().numpy().copy(),
                rb_out=g0.block_out_edges().cpu().numpy().copy())
            self.inc = IncrementalPullMatrix(self.hot.view(), aux)
        else:
            self.inc = IncrementalPullMatrix.from_snapshot(g0, dtype=dt,
                                                           padded=True)
        # device-resident engine operands, patched in place per batch;
        # copies, never views of the host twins in inc.aux
        self._out_deg = g0.out_deg.clone()
        self._rb_in = torch.tensor(self.inc.aux.rb_in, device=dev)
        self._rb_out = torch.tensor(self.inc.aux.rb_out, device=dev)
        self._bmat = torch.tensor(self.inc.aux.bmat, device=dev)
        # host twin of the out-degree mirror, patched in O(batch): the push
        # seed divides by the sources' degrees before and after a batch, and
        # the integrity check digests the device mirror against it
        self._out_deg_host = g0.out_deg.cpu().numpy().copy()

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

    def _new_walks(self) -> we.WalkState:
        cfg = self.config
        return we.WalkState(
            self.hg, R=cfg.resolved_walks_per_vertex,
            L=cfg.resolved_walk_length, seed=cfg.resolved_walk_seed,
            alpha=cfg.alpha, dtype=self._dtype, device=self.device)

    def _init_walk(self, g: Optional[GraphSnapshot]) -> None:
        """Walk mode (``engine="walk"``): no sweeps and no pull operands —
        the session owns a :class:`~repro_torch.core.walk_engine.WalkState`
        (R walk segments per vertex on the device) and every rank read
        derives from its visit counters.  A caller's ``r0`` (and a
        restore's stored ranks) is ignored: regeneration is deterministic in
        (graph, seed), so a WAL replay reproduces the walks and counters
        exactly.  ``from_snapshot`` without ``hg=`` recovers the host edges
        without the snapshot's self-loops (the walks re-add them by
        sampling)."""
        if self.hg is None:
            self.hg = we.host_graph_of(g)
        self.g = None
        self.inc = None
        self.n = self.n_pad = self.hg.n
        self.block_size, self.n_rb = self.config.block_size, 0
        self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
        self.walks = self._new_walks()
        self.R = self.walks.pagerank()

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
    def _set_baseline(self, R: torch.Tensor) -> None:
        """Adopt ``R`` as the drift baseline ``_r_verified``.  With
        ``integrity=`` set it is a copy (8 MB at n = 1M), so no in-place
        write to a rank vector can reach it.  Without it the main path takes
        no copy: the drivers return a fresh iterate every drive and no path
        writes ``self.R`` in place (the ``rank`` kind flips a copy), so a
        ``verify()`` still finds any drift from the drive's output."""
        self._r_verified = (R.clone() if self.config.integrity is not None
                            else R)

    def _drive(self, R0, affected, *, expand: bool, full: bool = False
               ) -> Tuple[torch.Tensor, SweepStats, int]:
        """Run the fused driver over the device-resident operand mirrors;
        returns (ranks, stats, host syncs made).  ``full``: every row-block
        is affected and stays so (see ``pallas_engine._driver``).

        With ``EngineConfig(integrity=…)`` the four invariants of the
        iterate (:func:`~repro_torch.core.integrity.invariant_vec`) ride
        every poll of the drive, so the per-drive check costs no host sync.
        A violated invariant raises nothing here (the batch is applied); it
        posts ``_integrity_alert`` for :meth:`update` / :meth:`verify` to
        repair."""
        cfg = self.config
        part, alive, delay, crashed = self._fault_tables
        tiered = self._tiered
        icfg = cfg.integrity
        fused = (icfg is not None and icfg.fused
                 and self._r_verified is not None)
        R, sv, syncs = pe._driver(
            self.inc.mat, R0, affected, self.valid, self._out_deg,
            self._rb_in, self._rb_out, self._bmat,
            self._alpha, self._tau, self._tau_f,
            part, alive, delay, crashed,
            n=self.n, block_size=self.block_size, mode=cfg.mode,
            expand=expand, active_policy=cfg.active_policy,
            max_iterations=cfg.max_iterations, full=full,
            rb_res=self.hot.rb_res if tiered else None, tiered=tiered,
            R_ref=self._r_verified if fused else None)
        def_pending = False
        if tiered:
            # the deferral indicator rode the drive's last poll
            self._deferred_rb = sv[-self.n_rb:] != 0
            def_pending = bool(self._deferred_rb.any())
            sv = sv[:-self.n_rb]
        stats = pe._stats_from_vec(sv[:7])
        if not fused:
            self._set_baseline(R)
            return R, stats, syncs
        mass_err, neg, nonfinite, _drift = (float(x) for x in sv[7:])
        # the drift term is informational here (a drive moves ranks away
        # from the pre-batch baseline); mass is gated on converged iterates
        # only, and on a tiered session only once no deferred block is
        # pending (mid-refill iterates carry those blocks' stale mass)
        self._integrity_checks += 3
        alert = None
        if nonfinite > 0:
            alert = {"check": "rank_finite", "count": int(nonfinite)}
        elif neg > 0:
            alert = {"check": "rank_negativity", "count": int(neg)}
        elif (stats.converged and not def_pending
                and mass_err > icfg.mass_tol):
            alert = {"check": "rank_mass", "mass_error": mass_err}
        if alert is None:
            self._set_baseline(R)
        else:
            self._integrity_alert = alert
        return R, stats, syncs

    # -- the tiered refill loop ----------------------------------------------
    def _admit(self, want_rb) -> None:
        """Admit row-blocks into the hot slab and rebind the device view
        (tiered streams only)."""
        self.hot.admit(want_rb)
        self.inc.mat = self.hot.view()

    def _mask_from_indices(self, idx: np.ndarray) -> torch.Tensor:
        """Device indicator from a host index list: only the list crosses
        to the device, never an O(n) vector."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        ind = torch.zeros(self.n_pad + 1, dtype=torch.bool,
                          device=self.device)
        if len(idx):
            ind[ops._upload(np.minimum(idx, self.n_pad), self.device)] = True
        return ind[:self.n_pad] & self.valid

    def _drive_refill(self, R0, affected, *, want_rb
                      ) -> Tuple[torch.Tensor, SweepStats, int]:
        """Admission + fused drive + deferred-refill loop of a tiered
        session, always expanding; returns (ranks, stats, host syncs made).

        Admit the want set, drive, and while the driver deferred
        non-resident blocks, admit those and re-drive with exactly the
        deferred blocks re-marked affected (the paper's helping mechanism
        applied to residency misses).  ``max_iterations`` rounds is the
        safety cap (:class:`SweepCapWarning`).

        Drain criterion (the reference's): the loop stops once every
        currently deferred block has been re-driven during an unbroken run
        of *quiet* rounds — rounds whose max rank movement stayed at or
        below ``tau``, or at the float ulp floor when ``tau`` sits under
        machine precision (counted in ``refill_stalls``).  Each quiet-round
        check reads one or two scalars: a host sync each.  ``want_rb=None``
        admits nothing before the first drive (a repair re-drive)."""
        if want_rb is not None:
            self._admit(want_rb)
        R, agg, syncs = self._drive(R0, affected, expand=True)
        rounds = 0
        eps = float(torch.finfo(R.dtype).eps)
        tau = float(self.config.tau)
        quiet_driven = np.zeros(self.n_rb, bool)
        while self._deferred_rb is not None and self._deferred_rb.any():
            if rounds >= int(self.config.max_iterations):
                warnings.warn(
                    f"tiered refill loop did not drain in {rounds} rounds "
                    "— serving the best iterate (raise "
                    "device_budget_bytes)", SweepCapWarning, stacklevel=3)
                agg = dataclasses.replace(agg, converged=False)
                break
            rounds += 1
            deferred = self._deferred_rb
            pending = np.nonzero(deferred)[0]
            self._admit(pending)
            aff = _block_rows(ops._upload(deferred, self.device),
                              self.block_size) & self.valid
            R_prev = R
            R, st, s = self._drive(R, aff, expand=True)
            syncs += s
            agg = _add_drive(agg, st)
            # drain check: a quiet round extends the window with the blocks
            # it re-drove; a loud round (or an unconverged drive) resets it
            driven = pending[self.hot.resident[pending]]
            quiet = at_floor = False
            if st.converged and len(driven):
                delta = float((R - R_prev).abs().max())
                syncs += 1
                if delta <= tau:
                    quiet = True
                else:
                    rmax = float(R.abs().max())
                    syncs += 1
                    at_floor = delta <= 16.0 * eps * max(rmax, eps)
                    quiet = at_floor
            if quiet:
                quiet_driven[driven] = True
                cur = np.nonzero(self._deferred_rb)[0]
                if quiet_driven[cur].all():
                    if at_floor:
                        self.hot.counters["refill_stalls"] += 1
                    self._deferred_rb = np.zeros_like(deferred)
                    break
            else:
                quiet_driven[:] = False
        self.hot.counters["refill_drives"] += rounds
        return R, agg, syncs

    # -- the residual forward-push solve -------------------------------------
    def _on_valid(self, value: float) -> torch.Tensor:
        """``value`` on the valid vertices, 0 on the padding: the static
        start ``1/n`` and the teleport residual ``b = (1−α)/n`` of p = 0."""
        v = torch.tensor(value, dtype=self._dtype, device=self.device)
        return torch.where(self.valid, v, torch.zeros_like(v))

    def _drive_push(self, P0) -> Tuple[torch.Tensor, SweepStats, dict, int]:
        """One fused push drive over the device-resident operand mirrors:
        ranks + carried residual in, ranks + shrunk residual out; returns
        (ranks, stats, push extras, host syncs made).  On a tiered session
        the deferral indicator rides the drive's last poll."""
        tiered = self._tiered
        P, Rr, sv, syncs = pshe._push_driver(
            self.inc.mat, P0, self._residual, self.valid, self._out_deg,
            self._bmat, self._alpha, self._tau, n=self.n,
            block_size=self.block_size,
            max_iterations=self.config.max_iterations,
            rb_res=self.hot.rb_res if tiered else None, tiered=tiered)
        if tiered:
            self._deferred_rb = sv[pshe.STATS_LEN:] != 0
            sv = sv[:pshe.STATS_LEN]
        self._residual = Rr
        self._set_baseline(P)
        stats, extras = pshe.push_stats_from_vec(sv)
        return P, stats, extras, syncs

    def _drive_push_refill(self, P0, *, want_rb=None
                           ) -> Tuple[torch.Tensor, SweepStats, dict, int]:
        """Admission + push drive + stale-refresh refill loop (the push twin
        of :meth:`_drive_refill`); an untiered session makes one plain
        :meth:`_drive_push`.  A drive delivers pushes to resident
        destination blocks only; the blocks it pushed to while off the
        device are stale and sit in the deferred indicator.  Each round
        admits them, rebuilds the admitted ones' residual exactly
        (:func:`~repro_torch.core.push_engine.residual_refresh_blocks`) and
        re-drives, until the indicator drains; blocks the slab could not
        take stay deferred.  No quiet-window drain is needed: ``p`` is
        exact everywhere at all times, so a drained indicator IS
        convergence.  ``max_iterations`` rounds is the safety cap
        (:class:`SweepCapWarning`)."""
        if not self._tiered:
            return self._drive_push(P0)
        if want_rb is not None:
            self._admit(want_rb)
        P, agg, extras, syncs = self._drive_push(P0)
        pushed = extras["pushed_blocks"]
        rounds = 0
        while self._deferred_rb.any():
            if rounds >= int(self.config.max_iterations):
                warnings.warn(
                    f"tiered push refill loop did not drain in {rounds} "
                    "rounds — serving the best iterate (raise "
                    "device_budget_bytes)", SweepCapWarning, stacklevel=3)
                agg = dataclasses.replace(agg, converged=False)
                break
            rounds += 1
            pending = np.nonzero(self._deferred_rb)[0]
            self._admit(pending)
            got = pending[self.hot.resident[pending]]
            if len(got):
                ids = np.full(self.n_rb, -1, np.int32)
                ids[:len(got)] = got
                self._residual = pshe.residual_refresh_blocks(
                    self.inc.mat, P, self._residual, self.valid,
                    self._out_deg, self._alpha,
                    ops._upload(ids, self.device),
                    ops._upload(np.array([len(got)], np.int64), self.device),
                    n=self.n, block_size=self.block_size)
            leftover = np.zeros(self.n_rb, bool)
            leftover[pending] = ~self.hot.resident[pending]
            P, st, extras, s = self._drive_push(P)
            syncs += s
            pushed += extras["pushed_blocks"]
            agg = _add_drive(agg, st)
            self._deferred_rb |= leftover
        self.hot.counters["refill_drives"] += rounds
        return P, agg, {**extras, "pushed_blocks": pushed}, syncs

    def _residual_recompute(self, P) -> torch.Tensor:
        """Exact O(m) residual rebuild ``r = b + M·p − p`` for the current
        graph (nd / given-ranks path): one launch of kernel #1, or on a
        tiered session, whose device matrix is only the slab's view, a walk
        of host truth (:func:`~repro_torch.core.push_engine.
        residual_from_host`, one read of ``p``)."""
        if self._tiered:
            return ops._upload(pshe.residual_from_host(
                self.hg, self._out_deg_host, P.cpu().numpy(),
                float(self.config.alpha)), self.device)
        return pshe.residual_full(self.inc.mat, P, self.valid, self._out_deg,
                                  self._alpha, n=self.n)

    def _seed_push(self, variant: str, sources=None, deg_old_src=None
                   ) -> Tuple[torch.Tensor, int, Optional[np.ndarray]]:
        """Set the session residual for one applied batch and return
        ``(P0, host syncs made, seed indices)``.  ``df`` is the
        O(batch·deg) path: the batch changes the pull matrix only in its
        effective source columns (``sources``, whose pre-batch degrees are
        ``deg_old_src``), so ``Δr = (M' − M)·p`` is enumerated on the host
        and applied by one deterministic device scatter; reading ``p`` at
        the sources is the one host sync, and the scatter's indices are the
        seed a tiered session admits with.  ``nd`` keeps ``p`` and rebuilds
        the exact residual (O(m)); ``static`` restarts cold (p = 0,
        r = b); neither has a seed."""
        if variant == "df":
            if not len(sources):
                return self.R, 0, np.zeros(0, np.int64)
            p_src = self.R[ops._upload(sources, self.device)].cpu().numpy()
            sidx, svals = pshe.residual_seed_host(
                self._hg_prev, self.hg, sources, p_src, deg_old_src,
                self._out_deg_host[sources], float(self.config.alpha))
            self._residual = pshe.scatter_residual(self._residual, sidx,
                                                   svals)
            return self.R, 1, sidx
        if variant == "nd":
            self._residual = self._residual_recompute(self.R)
            return self.R, int(self._tiered), None
        self._residual = self._on_valid((1.0 - self.config.alpha) / self.n)
        return torch.zeros(self.n_pad, dtype=self._dtype,
                           device=self.device), 0, None

    def _solve(self, variant: str, affected=None, want_rb=None, P0=None
               ) -> Tuple[torch.Tensor, SweepStats, Optional[dict], int]:
        """One solve of the current graph: the start state and active set
        of ``variant`` on the session's driver, then its drive.  Returns
        (ranks, stats, push extras or None, host syncs made).  A push
        session starts from ``P0``, which :meth:`_seed_push` made.  On the
        pull driver ``df`` takes the seeded ``affected`` mask; ``dt`` takes
        the reachability mask ``affected`` and starts warm without
        expansion; ``nd`` starts warm and ``static`` cold, with every
        vertex affected.  A tiered session admits ``want_rb`` first and
        drives through its refill loop; the pull's always expands: the
        loop is block-Jacobi over residency partitions, and only expansion
        re-marks a resident block whose non-resident inputs moved later."""
        if self._push:
            return self._drive_push_refill(P0, want_rb=want_rb)
        if self._tiered:
            R0 = self.R
            if variant in ("nd", "static"):
                affected = self.valid
            if variant == "static":
                R0 = self._on_valid(1.0 / self.n)
            R, stats, syncs = self._drive_refill(R0, affected,
                                                 want_rb=want_rb)
            return R, stats, None, syncs
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
        affected = sources = deg_old_src = P0 = None
        if self._push:
            # the push seed divides by the PRE-batch degrees of the
            # effective sources: read them before the mirror patch
            sources = np.unique(np.concatenate([dels_eff[:, 0],
                                                ins_eff[:, 0]]))
            deg_old_src = self._out_deg_host[sources]
        # a pending torn-scatter corruption (scatter_drop / scatter_dup)
        # skips or double-applies the device patch only; the host twins stay
        # truth, which is how the mirror digests detect the tear
        scatter_fault, self._scatter_fault = self._scatter_fault, None
        if len(rows):
            np.add.at(self._out_deg_host, cols,
                      vals.astype(self._out_deg_host.dtype))
            delta = (torch.as_tensor(rows, device=dev),
                     torch.as_tensor(cols, device=dev),
                     torch.as_tensor(vals.astype(np.int32), device=dev))
            for _ in range({"scatter_drop": 0,
                            "scatter_dup": 2}.get(scatter_fault, 1)):
                _apply_operand_delta(self._out_deg, self._rb_in,
                                     self._rb_out, self._bmat, *delta,
                                     block=B)
        seed = h_prev = plan = None
        if self._tiered:
            # host tier first: patch host truth and the host aux twins, and
            # drop residency of the touched blocks (their slab entries are
            # stale; the admission below packs them afresh)
            plan = self.pool.apply_delta(rows, cols, vals)
            self.inc.aux.apply_delta(B, rows, cols, vals)
            self.hot.invalidate(
                plan.touched_rb,
                structure_changed=(plan.tile_cols is not None
                                   or plan.n_new > plan.n_old))
        else:
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
        if self.config.integrity is not None:
            # the digest tracks every legitimate rebinding of the host graph;
            # a change to its keys that does not pass here is what the deep
            # check's graph_digest catches
            self._hg_digest = self._graph_digest()
        raw = (np.asarray(deletions).reshape(-1, 2).shape[0]
               + np.asarray(insertions).reshape(-1, 2).shape[0])

        seed_syncs = 0
        seed_idx = None
        if self._push:
            # the residual seed replaces the DF marking; its indices feed
            # a tiered session's want set, as the pull's DF seed does
            P0, seed_syncs, seed_idx = self._seed_push(variant, sources,
                                                       deg_old_src)
        elif variant == "df" and self._tiered:
            # host-side DF seed through the sorted host key sets: no device
            # pull matrix, only the index list crosses to the device
            srcs = [np.asarray(e, np.int64).reshape(-1, 2)[:, 0]
                    for e in (deletions, insertions)]
            seed_idx = dist.df_seed_indices(self._hg_prev, self.hg,
                                            np.concatenate(srcs))
            affected = self._mask_from_indices(seed_idx)
        elif variant == "df":
            hit = h_prev | _seed_pass(self.inc.mat, seed)       # ∪ G^t
            affected = _seed_mask(hit, seed, self.valid, block_size=B)
        elif variant == "dt":
            g_new_snap = self._snapshot(self.hg)
            affected, hops, seed_syncs = fr._dt_reach(
                g_prev_snap, g_new_snap,
                fr.batch_to_device(g_new_snap, deletions, insertions))
            self._dt_bfs = (hops, seed_syncs)
        want_rb = None
        if self._tiered:
            # frontier-biased admission before the drive: the touched
            # blocks, the seed blocks and their tile-adjacent candidates
            # (the first expansion wave), in one batch
            want = [np.asarray(plan.touched_rb, np.int64)]
            if seed_idx is not None and len(seed_idx):
                srb = np.unique(seed_idx // B)
                want += [srb,
                         np.nonzero(self.inc.aux.bmat[:, srb].any(axis=1))[0]]
            want_rb = np.concatenate(want)
        R, stats, extras, syncs = self._solve(variant, affected,
                                              want_rb=want_rb, P0=P0)
        self.R = R
        return StreamBatchResult(
            ranks=R, stats=stats, wall_time_s=time.perf_counter() - t0,
            batch_edges=raw, driver_retraces=nvcc.total_builds() - builds0,
            host_syncs=syncs + seed_syncs,
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

    def _update_walk(self, deletions, insertions) -> StreamBatchResult:
        """Walk-mode step: patch the adjacency slabs and regenerate only the
        walks that visit a touched vertex (``walk_touch`` finds them,
        ``walk_regen`` rebuilds them).  Every variant takes this path: walk
        invalidation is the frontier, as in the reference."""
        t0 = time.perf_counter()
        builds0 = nvcc.total_builds()
        syncs0 = self.walks.host_syncs
        dels_eff, ins_eff = effective_batch(self.hg, deletions, insertions)
        self.hg = self.hg.apply_batch(deletions, insertions)
        wstats = self.walks.apply_batch(dels_eff, ins_eff)
        self.R = self.walks.pagerank()
        raw = (np.asarray(deletions).reshape(-1, 2).shape[0]
               + np.asarray(insertions).reshape(-1, 2).shape[0])
        stats = SweepStats(sweeps=1, iterations=1, blocks_processed=0,
                           edges_processed=wstats.steps, converged=True)
        return StreamBatchResult(
            ranks=self.R, stats=stats,
            wall_time_s=time.perf_counter() - t0, batch_edges=raw,
            driver_retraces=nvcc.total_builds() - builds0,
            host_syncs=self.walks.host_syncs - syncs0,
            regenerated_walks=wstats.regenerated_walks,
            touched_walks=wstats.touched_walk_mass,
            total_walks=wstats.total_walks)

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
        # validate BEFORE the WAL append and before any device write: a bad
        # batch raises here, is never logged and never replays
        deletions, insertions = validate_edge_batch(deletions, insertions,
                                                    self.n)
        # a scheduled silent corruption lands on live state BEFORE the batch,
        # so this drive's fused invariants (or the next verify) must be what
        # detects it
        if self._corruption_faults is not None and not self._replaying:
            cfault = self._corruption_faults.pop_pending()
            if cfault is not None:
                self._apply_corruption(cfault)
        bidx = self._batch_index + 1
        wal_undo = None
        if self.store is not None and not self._replaying:
            wal_undo = self.store.wal_size()
        try:
            if wal_undo is not None:
                # write-ahead: the batch is durable before any device write;
                # inside the try, so a failed append rolls back as well
                self.store.append_wal(
                    batch_index=bidx, variant=variant,
                    deletions=np.asarray(deletions,
                                         np.int64).reshape(-1, 2),
                    insertions=np.asarray(insertions,
                                          np.int64).reshape(-1, 2))
            if self._walk:
                res = self._update_walk(deletions, insertions)
            elif self._stream:
                res = self._update_stream(deletions, insertions, variant)
            else:
                res = self._update_snapshot(deletions, insertions, variant)
        except BaseException:
            # the session refused the batch: revoke its record so a restore
            # does not replay what the live session never held
            if wal_undo is not None:
                self.store.truncate_wal(wal_undo)
            raise
        self._batch_index = bidx
        self._history.append(res)
        if not res.stats.converged:
            warnings.warn(
                f"update batch {bidx} hit the sweep cap "
                f"(max_iterations={self.config.max_iterations}) without "
                f"reaching tau={self.config.tau} — serving the best iterate",
                SweepCapWarning, stacklevel=2)
        if (self._process_domain is not None and not self._replaying
                and bidx % self._process_domain.checkpoint_interval == 0):
            self._checkpoint_now()
        # fused detection → repair ladder, inside the same update call (the
        # batch itself was applied; only the state needs repairing)
        if self._integrity_alert is not None and not self._replaying:
            icfg = self.config.integrity
            if icfg is not None and icfg.auto_repair:
                self.verify(repair=True, deep=False)
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
        res = self._recompute(variant)
        if self._process_domain is not None and not self._replaying:
            # recompute changes the served ranks outside the WAL's batch
            # stream: checkpoint, so restore() serves what the session did
            self._checkpoint_now()
        return res

    def _recompute_walk(self, variant: str) -> PagerankResult:
        """Walk-mode re-solve: regenerate EVERY walk from the current graph
        (``static``/``nd``, both cold: there is no warm iterate).  The
        marking replays (``dt``/``df``) have no walk analogue and raise, as
        in the reference."""
        if variant not in ("static", "nd"):
            raise ValueError(
                f"recompute({variant!r}) replays a sweep-engine affected "
                "marking, which the walk engine does not have — walk "
                "sessions regenerate globally via variant='static'/'nd' "
                "(per-delta localization happens inside update())")
        t0 = time.perf_counter()
        self.walks = self._new_walks()
        self.R = self.walks.pagerank()
        stats = SweepStats(sweeps=1, iterations=1,
                           edges_processed=self.walks.total_steps,
                           converged=True)
        return PagerankResult(ranks=self.R, stats=stats,
                              wall_time_s=time.perf_counter() - t0)

    def _recompute(self, variant: str) -> PagerankResult:
        if self._walk:
            return self._recompute_walk(variant)
        if variant in ("df", "dt") and self._push:
            raise ValueError(
                f"recompute({variant!r}) replays the pull driver's "
                "frontier marking; a driver='push' session re-solves via "
                "variant='static' or 'nd'")
        if variant in ("static", "nd"):
            if self._stream:
                t0 = time.perf_counter()
                P0 = self._seed_push(variant)[0] if self._push else None
                R, stats, _, _ = self._solve(
                    variant, want_rb=(np.arange(self.n_rb) if self._tiered
                                      else None), P0=P0)
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
        if self._stream and not self._tiered:
            # reuse the incrementally maintained operands; a tiered session
            # holds only a partial device view, so its replay (an O(m)
            # what-if path) builds a full throwaway matrix instead
            mat, aux = self.inc.mat, self.inc.aux
        return self._converge(R0, affected, expand=(variant == "df"),
                              g=g_cur, mat=mat, aux=aux)

    # -- the corruption fault domain (core/integrity.py) ---------------------
    def _graph_digest(self) -> int:
        """CRC32 of the host graph's sorted edge keys, from which its edge
        list derives: the host-truth identity the deep check compares."""
        return zlib.crc32(
            np.ascontiguousarray(self.hg._keys).tobytes()) & 0xFFFFFFFF

    def _integrity_cfg(self) -> ig.IntegrityConfig:
        icfg = self.config.integrity
        return icfg if icfg is not None else ig.IntegrityConfig()

    def _integrity_check(self, icfg: ig.IntegrityConfig, *, deep: bool
                         ) -> Tuple[List[dict], int, float, float,
                                    Dict[str, float]]:
        """One detection pass, NO repair: ``(failures, checks_run,
        mass_error, drift, split_s)``.  The rank invariants always run;
        stream mode adds the mirror digests, the tile-pool sum check, the
        slot-table check and (untiered) the packed-index check, or (tiered)
        the slab scrub; ``deep`` adds the host-graph digest.  The
        packed-index check extends the sum check and is counted with it, so
        ``checks_run`` counts as the reference's does.  ``split_s`` holds
        the seconds of each part (``ranks``, ``digests``, ``sums``,
        ``slot_tables``, ``hot_slab``, ``graph_digest``); each part ends in
        a read to the host, so its time includes its device work."""
        failures: List[dict] = []
        checks = 0
        split: Dict[str, float] = {}
        t0 = time.perf_counter()

        def lap(part: str) -> None:
            nonlocal t0
            t = time.perf_counter()
            split[part] = t - t0
            t0 = t

        ref = self._r_verified if self._r_verified is not None else self.R
        inv = ig.invariant_vec(self.R, ref, self.valid).cpu().numpy()
        mass_err, neg, nonfinite, drift = (float(x) for x in inv)
        checks += 4
        if nonfinite > 0:
            failures.append({"check": "rank_finite",
                             "count": int(nonfinite)})
        if neg > 0:
            failures.append({"check": "rank_negativity", "count": int(neg)})
        # a sweep-capped iterate legitimately carries residual mass <= n*tau
        converged = (not self._history
                     or bool(self._history[-1].stats.converged))
        if converged and mass_err > icfg.mass_tol:
            failures.append({"check": "rank_mass", "mass_error": mass_err})
        # between drives the ranks equal the last verified iterate (queries
        # never write), so any drift is corruption
        if drift > icfg.drift_tol:
            failures.append({"check": "rank_drift", "drift": drift})
        lap("ranks")
        if not self._stream:
            return failures, checks, mass_err, drift, split
        aux = self.inc.aux
        mirrors = (("out_deg", self._out_deg, self._out_deg_host),
                   ("rb_in", self._rb_in, aux.rb_in),
                   ("rb_out", self._rb_out, aux.rb_out),
                   ("bmat", self._bmat, aux.bmat))
        for name, dev, host in mirrors:
            checks += 1
            bad = ig.compare_digests(dev, host,
                                     chunk_bytes=icfg.scrub_chunk_bytes)
            if bad:
                failures.append({"check": "mirror_digest", "mirror": name,
                                 "chunks": bad[:8]})
        lap("digests")
        # every stored entry is 1.0, so the live entries of row-block i sum
        # to rb_in[i]: host truth on a tiered session (its slab is CRCed
        # below); untiered, both copies of the matrix — the dense pool and
        # the packed index the kernels read, whose one walk also yields
        # the packed-index check's findings
        checks += 1
        mat = self.inc.mat
        index_bad: List[dict] = []
        if self._tiered:
            bad_rb = np.abs(self.pool.row_sums() - aux.rb_in) > ig.COUNT_TOL
        else:
            index_sums, index_bad = ig.check_packed_index(mat)
            bad_rb = ((np.abs(ig.tile_row_sums(mat) - aux.rb_in)
                       > ig.COUNT_TOL)
                      | (np.abs(index_sums - aux.rb_in) > ig.COUNT_TOL))
        if bad_rb.any():
            failures.append({"check": "tile_sums",
                             "row_blocks": np.nonzero(bad_rb)[0][:8]
                             .tolist()})
        lap("sums")
        checks += 1
        if self._tiered:
            failures.extend(ig.check_slot_tables(
                self.pool.tile_cols, self.pool.mat.tile_idx, aux.bmat,
                int(self.pool.mat.tiles.shape[0])))
            lap("slot_tables")
            checks += 1
            failures.extend(self.hot.scrub())
            lap("hot_slab")
        else:
            failures.extend(ig.check_slot_tables(
                mat.tile_cols, mat.tile_idx, aux.bmat, mat.tile_capacity))
            lap("slot_tables")
            failures.extend(index_bad)
        if deep and self._hg_digest is not None:
            checks += 1
            if self._graph_digest() != self._hg_digest:
                failures.append({"check": "graph_digest"})
            lap("graph_digest")
        return failures, checks, mass_err, drift, split

    def verify(self, *, repair: Optional[bool] = None,
               deep: bool = True) -> ig.IntegrityReport:
        """Run the corruption domain's checks on the live state and (by
        default, per ``IntegrityConfig.auto_repair``) climb the repair
        ladder on any failure.

        Checks: the rank invariants (mass, non-negativity, finiteness, the
        exact drift from the last verified iterate), and in stream mode the
        chunked digests of the operand mirrors against their host twins,
        the tile-pool sum check over the dense pool and the packed index,
        the slot-table check and the packed-index check (a tiered session:
        host truth and the slab scrub); ``deep=True`` adds the host-graph
        digest.  The ladder (``"frontier"`` → ``"rebuild"`` →
        ``"restore"``) re-marks corrupted rows into the DF frontier and
        helps them to convergence, rebuilds the device operands from host
        truth, or restores from the durable store; each rung re-checks,
        escalates on failure and records a
        ``RecoveryRecord(domain="corruption")``."""
        self._ensure_open()
        self._no_walk("verify()")
        t0 = time.perf_counter()
        icfg = self._integrity_cfg()
        if repair is None:
            repair = icfg.auto_repair
        alert, self._integrity_alert = self._integrity_alert, None
        failures, checks, mass_err, drift, split = self._integrity_check(
            icfg, deep=deep)
        self._integrity_checks += checks
        if alert is not None and not any(f["check"] == alert["check"]
                                         for f in failures):
            # the fused drive flagged it even if the state has since moved
            failures = [dict(alert, fused=True)] + failures
        repairs: List[str] = []
        rung_s: Dict[str, float] = {}
        ok = not failures
        if failures:
            self._corruption_detected += 1
            if repair:
                ok, repairs, mass_err, drift, rung_s = \
                    self._repair_corruption(failures, icfg, deep=deep)
        if ok:
            self._r_verified = self.R.clone()
            # a rung's own drive may have posted an alert against the
            # pre-repair baseline; the clean re-check supersedes it
            self._integrity_alert = None
        return ig.IntegrityReport(
            ok=ok, checks_run=checks, failures=failures, repairs=repairs,
            mass_error=mass_err, drift=drift,
            wall_time_s=time.perf_counter() - t0, split_s=split,
            rung_s=rung_s)

    def _repair_corruption(self, failures: List[dict],
                           icfg: ig.IntegrityConfig, *, deep: bool
                           ) -> Tuple[bool, List[str], float, float,
                                      Dict[str, float]]:
        """Climb the ladder from the cheapest rung the failures allow,
        re-checking after each rung and escalating while damage remains.
        Returns ``(ok, rungs_applied, mass_error, drift, rung_s)``:
        ``rung_s`` holds each applied rung's seconds alone, without the
        re-check that its ``RecoveryRecord`` also spans."""
        checks = {f["check"] for f in failures}
        if "graph_digest" in checks:
            start = "restore"       # the host truth itself is damaged
        elif checks & {"mirror_digest", "tile_sums", "slot_tables",
                       "hot_slab", "packed_index"}:
            start = "rebuild"
        else:
            start = "frontier"
        detected = failures[0]["check"]
        repairs: List[str] = []
        rung_s: Dict[str, float] = {}
        mass_err = drift = float("nan")
        for rung in ig.REPAIR_RUNGS[ig.REPAIR_RUNGS.index(start):]:
            t0 = time.perf_counter()
            applied = self._apply_repair_rung(rung, icfg)
            if applied is None:     # the rung does not apply (no store)
                continue
            # the rung's last drive reads its convergence flag on the host,
            # so its device work is done here
            rung_s[rung] = time.perf_counter() - t0
            desc, reconverged = applied
            left, checks_run, mass_err, drift, _ = self._integrity_check(
                icfg, deep=deep or rung == "restore")
            self._integrity_checks += checks_run
            self._recoveries.append(fault_domain.RecoveryRecord(
                domain="corruption", batch_index=self._batch_index,
                wall_time_s=time.perf_counter() - t0, rung=rung,
                check=detected, description=desc))
            repairs.append(rung)
            # a sweep-capped repair drive is not a repair even when the
            # checks pass: escalate until a rung reconverges
            if not left and reconverged:
                return True, repairs, mass_err, drift, rung_s
        return False, repairs, mass_err, drift, rung_s

    def _repair_drive(self, R0, affected, *, want_rb=None
                      ) -> Tuple[torch.Tensor, SweepStats]:
        """A repair rung's expanding drive: through the refill loop on a
        tiered session, one fused drive otherwise."""
        if self._tiered:
            R, st, _ = self._drive_refill(R0, affected, want_rb=want_rb)
        else:
            R, st, _ = self._drive(R0, affected, expand=True)
        return R, st

    def _apply_repair_rung(self, rung: str, icfg: ig.IntegrityConfig
                           ) -> Optional[Tuple[str, bool]]:
        """Execute one ladder rung; returns ``(description, reconverged)``
        or ``None`` when the rung does not apply to this session."""
        if rung == "frontier":
            # the paper's helping mechanism aimed at corruption: corrupted
            # rows are reset to the last verified iterate and re-marked
            # affected, and DF expansion carries the correction outward
            ref = (self._r_verified if self._r_verified is not None
                   else self._on_valid(1.0 / self.n))
            bad = self.valid & (~torch.isfinite(self.R) | (self.R < 0)
                                | ((self.R - ref).abs() > icfg.drift_tol))
            n_bad = int(bad.sum())
            if n_bad:
                R0, affected = torch.where(bad, ref, self.R), bad
            else:
                # aggregate-only symptom (mass off, nothing localizable):
                # fall back to the verified iterate wholesale
                R0 = torch.where(self.valid, ref, torch.zeros_like(ref))
                affected = self.valid
            if self._stream:
                self.R, st = self._repair_drive(R0, affected)
                reconverged = bool(st.converged)
            else:
                self._converge(R0, affected, expand=True)
                reconverged = True
            return (f"{n_bad} corrupted rank(s) re-marked into the DF "
                    "frontier and helped back to convergence", reconverged)
        if rung == "rebuild":
            if not self._stream:
                return None         # nothing mirrored to rebuild
            g = self.hg.snapshot(block_size=self.block_size,
                                 device=self.device)
            # drop the damaged matrix before its replacement is allocated
            self.inc = self.pool = self.hot = None
            self._build_operands(g)
            self._scatter_fault = None
            # a cold uniform restart, not a warm start: the iterate and the
            # baseline may both have converged against the torn operands
            R, st = self._repair_drive(
                self._on_valid(1.0 / self.n), self.valid,
                want_rb=np.arange(self.n_rb) if self._tiered else None)
            self.R = R
            return ("operand mirrors + tile pool rebuilt from host truth; "
                    "full re-converge from the verified iterate",
                    bool(st.converged))
        if rung == "restore":
            if self.store is None:
                return None         # no durable store to fall back to
            svc, history = self._service, self._history
            warm, queries = self._warm_idx, self._queries
            recov = self._recoveries
            counters = (self._integrity_checks, self._corruption_detected)
            store_dir = self.store.dir
            fresh = type(self).restore(store_dir, device=self.device)
            replayed = sum(r.replayed_batches for r in fresh._recoveries)
            # adopt the restored state in place, keeping this session's
            # identity (service registration, history, counters)
            self.__dict__.update(fresh.__dict__)
            self._service = svc
            self._history, self._warm_idx, self._queries = (history, warm,
                                                            queries)
            self._recoveries = recov + fresh._recoveries
            self._integrity_checks, self._corruption_detected = counters
            return (f"checkpoint+WAL restore from {store_dir!r} "
                    f"({replayed} batch(es) replayed)", True)
        raise ValueError(f"unknown repair rung {rung!r}")

    def inject_corruption(self, kind: Union[str, "fault_domain."
                                                 "CorruptionFault"], *,
                          index: Optional[int] = None, seed: int = 0,
                          defer: bool = False
                          ) -> "fault_domain.CorruptionFault":
        """Silently corrupt live session state (chaos harness and tests; see
        ``fault_domain.CORRUPTION_KINDS``).  Nothing is raised or recorded:
        detection is the integrity checks' job.  ``defer=True`` queues the
        fault on the session's corruption domain instead, for the next
        :meth:`update` to apply right before its batch."""
        self._ensure_open()
        self._no_walk("inject_corruption()")
        if isinstance(kind, fault_domain.CorruptionFault):
            fault = kind
        else:
            fault = fault_domain.CorruptionFault(kind=str(kind), index=index,
                                                 seed=int(seed))
        if defer:
            if self._corruption_faults is None:
                self._corruption_faults = fault_domain.CorruptionFaultDomain()
            self._corruption_faults.inject(fault.kind, index=fault.index,
                                           seed=fault.seed)
        else:
            self._apply_corruption(fault)
        return fault

    def _apply_corruption(self, fault: "fault_domain.CorruptionFault"
                          ) -> None:
        """Apply one fault to the live copy only — never to a twin a check
        compares it with.  Sites and bits come from ``default_rng(seed)`` in
        the reference's order, so both packages damage the same place."""
        kind = fault.kind
        rng = np.random.default_rng(fault.seed)
        if kind in ("scatter_drop", "scatter_dup"):
            # consumed by the next _update_stream
            self._scatter_fault = kind
            return
        if kind == "rank":
            i = (int(fault.index) if fault.index is not None
                 else int(rng.integers(self.n)))
            val = self.R[i].cpu().numpy()
            R = self.R.clone()          # the live ranks only
            R[i] = ig.flipped_float(val, ig.exponent_bit(val.dtype, rng))
            self.R = R
            return
        if not self._stream:
            raise ValueError(
                f"corruption kind {kind!r} instruments stream-mode state "
                "(tile pool / slot tables / operand mirrors); only 'rank' "
                "and the scatter kinds apply elsewhere")
        if kind == "graph":
            keys = self.hg._keys      # hg.edges derives from the key set
            if len(keys) == 0:
                raise ValueError("graph corruption needs at least one edge")
            i = (int(fault.index) if fault.index is not None
                 else int(rng.integers(len(keys))))
            keys[i] ^= 1              # host-truth bit flip (dst ± 1)
            return
        if kind == "mirror":
            rb = (int(fault.index) if fault.index is not None
                  else int(rng.integers(self._rb_in.shape[0])))
            rb_in = self._rb_in.clone()
            rb_in[rb] += 3
            self._rb_in = rb_in
            return
        mat = self.inc.mat
        tc = (self.pool.tile_cols.copy() if self._tiered
              else mat.tile_cols.cpu().numpy())
        occ = np.argwhere(tc >= 0)
        if kind == "slot":
            r, c = (occ[int(fault.index) % len(occ)]
                    if fault.index is not None
                    else occ[int(rng.integers(len(occ)))])
            n_cb = int(self.inc.aux.bmat.shape[1])
            if self._tiered:
                # the slot tables' truth is the host tier (the structural
                # check reads the host tables)
                self.pool.mat.tile_cols[int(r), int(c)] = np.int32(n_cb + 5)
            else:
                # a new device table: the host twin tile_cols_h (which the
                # CPU table may share memory with) stays clean
                cols = mat.tile_cols.clone()
                cols[int(r), int(c)] = n_cb + 5
                self.inc.mat = dataclasses.replace(mat, tile_cols=cols)
            return
        # kind == "tile": flip an exponent bit of a live (1.0) entry, so the
        # change clears the sum check's tolerance
        if self._tiered:
            # the resident tile's slab entry on the card; host truth stays
            # clean, exactly the divergence the slab scrub CRCs
            tid_tbl = self.pool.tile_idx2d
            for rb in rng.permutation(sorted(self.hot._rb_slots)):
                rb = int(rb)
                slots = self.hot._rb_slots[rb]
                tids = tid_tbl[rb][self.pool.tile_cols[rb] >= 0]
                for tid, slot in zip(tids.tolist(), slots):
                    t = self.pool.mat.tiles[tid]
                    nz = np.argwhere(t != 0)
                    if len(nz):
                        bi, bj = (int(x) for x in
                                  nz[int(rng.integers(len(nz)))])
                        new = ig.flipped_float(
                            t[bi, bj], ig.exponent_bit(t.dtype, rng))
                        idx = self.hot._index
                        idx.val[_entry_of(idx, slot, bi, bj)] = new
                        return
            raise ValueError("no resident live tile entry to corrupt")
        tid_tbl = mat.tile_idx.cpu().numpy().reshape(tc.shape)
        for oi in rng.permutation(len(occ)):
            r, c = occ[oi]
            tid = int(tid_tbl[r, c])
            t = mat.tiles[tid].cpu().numpy()
            nz = np.argwhere(t != 0)
            if len(nz):
                bi, bj = (int(x) for x in nz[int(rng.integers(len(nz)))])
                new = ig.flipped_float(t[bi, bj],
                                       ig.exponent_bit(t.dtype, rng))
                # both copies: the dense pool the plain versions read and
                # refresh_index re-packs from, and the packed entry the
                # CUDA kernels read, so the damage is the same on either
                # device and survives a re-pack
                mat.tiles[tid, bi, bj] = new
                mat.index.val[_entry_of(mat.index, tid, bi, bj)] = new
                return
        raise ValueError("no live tile entry to corrupt")

    # -- serving reads -------------------------------------------------------
    def query(self, vertices: Union[int, Sequence[int], np.ndarray]
              ) -> np.ndarray:
        """Ranks of the given vertices: one device gather, only
        ``len(vertices)`` values cross to the host."""
        self._ensure_open()
        idx = _vertex_ids(vertices, self.n)
        vals = _gather(self.R, idx)
        self._queries += int(idx.shape[0])
        return vals

    def top_k(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(values, vertex ids) of the k highest-ranked vertices, computed on
        the device (ties: lower id first, as ``lax.top_k``)."""
        self._ensure_open()
        k = _top_k_count(k, self.n)
        out = _top_k(self.R, self.valid, k)
        self._queries += k
        return out

    def ppr_query(self, seeds, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(values, vertex ids) of the k highest **personalized** PageRank
        estimates for a uniform restart over ``seeds`` (ties lower id
        first): one device gather over the seeds' walks and a top-k, no
        regeneration.  Engines without the ``"ppr"`` capability raise
        :class:`~repro_torch.api.registry.CapabilityError`."""
        self._ensure_open()
        if not self._walk:
            raise _no_ppr(self.engine)
        seeds, k = _ppr_args(seeds, k, self.n)
        vals, idx = self.walks.ppr_top_k(seeds, k)
        self._queries += k
        return vals.cpu().numpy(), idx.cpu().numpy()

    def _no_walk(self, what: str) -> None:
        if self._walk:
            raise ValueError(
                f"{what} checks the sweep engines' state; the walk engine "
                "hosts no integrity checks (its only fault domain is "
                "'process')")

    def _read_view(self) -> ReadView:
        """The ranks-only copy a service serves degraded reads from."""
        self._ensure_open()
        return ReadView(self)

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

    @property
    def device_footprint(self) -> Tuple[int, ...]:
        """Ids of the devices this session's state occupies: the card's
        index on CUDA, ``(0,)`` on the CPU (as the reference gives there),
        ``()`` once closed."""
        if self._closed:
            return ()
        dev = self.R.device
        return (dev.index,) if dev.type == "cuda" else (0,)

    def _ensure_open(self) -> None:
        if self._closed:
            raise ValueError("session is closed — open a new "
                             "PageRankSession")

    def close(self) -> None:
        """End the session: unregister from any
        :class:`~repro_torch.api.service.PageRankService` and drop every
        device buffer reference.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        svc, self._service = self._service, None
        if svc is not None:
            svc._detach(self)
        for attr in ("R", "inc", "g", "valid", "_out_deg", "_rb_in",
                     "_rb_out", "_bmat", "_fault_tables", "_residual",
                     "_out_deg_host", "_hg_prev", "_g_prev", "_r_prev",
                     "store", "_process_domain", "pool", "hot",
                     "_deferred_rb", "_r_verified", "_corruption_faults",
                     "walks"):
            setattr(self, attr, None)

    def __enter__(self) -> "PageRankSession":
        self._ensure_open()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- durability / the process fault domain --------------------------------
    def _meta(self) -> dict:
        """JSON-able store meta: graph identity and the config's fields as
        the reference writes them (``faults`` / ``fault_domain`` are
        injection schedules, not state; ``dtype`` by its numpy name), so
        either package restores the other's store."""
        cfgd = {}
        for f in dataclasses.fields(self.config):
            if f.name in ("faults", "fault_domain"):
                continue
            v = getattr(self.config, f.name)
            if f.name == "dtype" and v is not None:
                v = str(as_torch_dtype(v)).removeprefix("torch.")
            if f.name == "integrity" and v is not None:
                v = v.to_dict()     # coerced back by EngineConfig
            cfgd[f.name] = v
        return {"format": 1, "kind": "pagerank-session",
                "n": int(self.hg.n), "config": cfgd}

    def _checkpoint_into(self, store: SessionStore) -> str:
        """One atomic checkpoint of the current state: the ranks of the n
        vertices and the host edge set, keyed by the applied-batch count."""
        if store.read_meta() is None:
            store.write_meta(self._meta())
        return store.checkpoint(
            ranks=self.R[:self.n].cpu().numpy(), edges=self.hg.edges,
            batch_index=self._batch_index)

    def _checkpoint_now(self) -> str:
        return self._checkpoint_into(self.store)

    def save(self, directory: Optional[str] = None) -> str:
        """Force one atomic checkpoint of the current state (ranks + edge
        set, keyed by the applied-batch count).  A durable session
        checkpoints into its store (which also shortens a later restore's
        replay); any session may pass ``directory`` to save into a fresh
        :class:`~repro_torch.ckpt.checkpoint.SessionStore`.  Returns the
        checkpoint's path."""
        self._ensure_open()
        if self.hg is None:
            raise ValueError("save() needs a host graph (from_graph, or "
                             "from_snapshot with hg=)")
        store = self.store
        if directory is not None and (
                store is None
                or os.path.abspath(directory) != os.path.abspath(store.dir)):
            store = SessionStore(directory)
        if store is None:
            raise ValueError(
                "save() needs a directory= (this session has no attached "
                "store; open it with durability='wal' + store_dir= for "
                "continuous durability)")
        return self._checkpoint_into(store)

    @classmethod
    def restore(cls, directory: str, *,
                config: Optional[EngineConfig] = None,
                device="cuda") -> "PageRankSession":
        """Reopen a session from its store on ``device``: the newest valid
        checkpoint (the pull matrix built fresh from its edges, its ranks
        taken as they are: no solve), then a replay through :meth:`update`
        of every batch the WAL logged after it.  ``config`` overrides the
        stored config.  The recovery shows in ``report()``
        (``replayed_batches``, ``recovery_time_s``)."""
        t0 = time.perf_counter()
        store = SessionStore(directory)
        meta = store.read_meta()
        if meta is None:
            raise ValueError(f"{directory!r} is not a session store "
                             "(missing meta.json)")
        got = store.restore_latest_state()
        if got is None:
            raise ValueError(f"{directory!r} holds no valid checkpoint "
                             "(all steps corrupt or none written)")
        state, ckpt_idx = got
        if config is None:
            config = EngineConfig.from_kwargs(**meta["config"])
        hg = HostGraph(int(meta["n"]), state["edges"])
        sess = cls(hg=hg, config=config, r0=state["ranks"], device=device,
                   store_dir=(directory if config.durability == "wal"
                              else None),
                   _restore_attach=True)
        sess._batch_index = ckpt_idx
        recs = store.read_wal(after=ckpt_idx)
        sess._replaying = True
        try:
            for rec in recs:
                sess.update(rec.deletions, rec.insertions,
                            variant=rec.variant)
        finally:
            sess._replaying = False
        # the replay built and loaded what the stream needs; with nothing
        # replayed the session is cold and report() excuses its first update
        sess._warm_idx = len(sess._history) if recs else None
        sess._recoveries.append(fault_domain.RecoveryRecord(
            domain="process", batch_index=ckpt_idx,
            wall_time_s=time.perf_counter() - t0,
            replayed_batches=len(recs),
            description=(f"restored from checkpoint {ckpt_idx} + "
                         f"{len(recs)} WAL batch(es)")))
        return sess

    # -- what-if branching ---------------------------------------------------
    def fork(self) -> "PageRankSession":
        """What-if branch: an independent session in the parent's state.
        The reference's fork shares its immutable device arrays; the port
        patches the tile pool, the packed index and the operand mirrors in
        place, so the fork copies every device tensor a later update writes
        (at n = 1M about one more tile pool).  The fork detaches from any
        store: two writers on one WAL would interleave."""
        self._ensure_open()
        new = object.__new__(PageRankSession)
        new.__dict__.update(self.__dict__)
        new._history = []
        new._warm_idx = 0 if self._warm_idx is not None else None
        new._queries = 0
        new._service = None       # forks are not registered with a service
        new.store = None
        new.store_dir = None
        new._process_domain = None
        new._recoveries = []
        new._replaying = False
        # integrity: the counters are per session, a pending tear or alert
        # stays with the parent
        new._integrity_checks = 0
        new._corruption_detected = 0
        new._integrity_alert = None
        new._scatter_fault = None
        if self._corruption_faults is not None:
            new._corruption_faults = fault_domain.CorruptionFaultDomain()
        for attr in ("R", "valid", "_residual", "_r_prev", "_out_deg",
                     "_rb_in", "_rb_out", "_bmat"):
            t = getattr(self, attr, None)
            if t is not None:
                setattr(new, attr, t.clone())
        if self.inc is not None:
            aux = self.inc.aux
            aux = (MatrixAux(bmat=aux.bmat.copy(), rb_in=aux.rb_in.copy(),
                             rb_out=aux.rb_out.copy())
                   if aux is not None else None)
            if self._tiered:
                # both tiers branch: the host pool copies, the hot set forks
                # over the copy (its packed slab cloned)
                new.pool = self.pool.copy()
                new.hot = self.hot.fork(new.pool)
                new._deferred_rb = None
                new.inc = IncrementalPullMatrix(new.hot.view(), aux)
            else:
                new.inc = IncrementalPullMatrix(self.inc.mat.clone(), aux)
            new._out_deg_host = self._out_deg_host.copy()
        if self._walk:
            new.walks = self.walks.fork()
        return new

    # -- warmup / reporting --------------------------------------------------
    def warmup(self) -> None:
        """Run the per-batch pipeline once without perturbing graph or rank
        state — a zero-value delta on vertex 0's self-loop tile, on a push
        session a residual scatter of one zero (its result dropped), and an
        empty-batch step — so the kernel library is built and loaded and the
        allocator holds the step's buffers before the first real update.
        A walk session regenerates its inert scratch row instead (the walk
        kernels' build).  Snapshot-mode sessions are already warm from
        their initial solve."""
        self._ensure_open()
        if self._walk:
            self.walks.warmup()
        elif self._stream:
            z = np.zeros(1, np.int64)
            if self._tiered:
                # the host-tier delta path and the invalidate → re-admit
                # pack, with a zero value: state is unperturbed
                self.pool.apply_delta(z, z, np.zeros(1))
                self.hot.invalidate(z)
                self._admit(z)
            else:
                self.inc.mat = ops.apply_delta(self.inc.mat, z, z,
                                               np.zeros(1))
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
        icfg = self.config.integrity
        integrity = None
        if (icfg is not None or self._integrity_checks
                or self._corruption_detected):
            by_rung = {r: 0 for r in ig.REPAIR_RUNGS}
            for rec in self._recoveries:
                if rec.domain == "corruption" and rec.rung in by_rung:
                    by_rung[rec.rung] += 1
            integrity = {
                "checks_run": int(self._integrity_checks),
                "corruption_detected": int(self._corruption_detected),
                "repairs": by_rung,
                "scrub_interval_s": (float(icfg.scrub_interval_s)
                                     if icfg is not None else None),
            }
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
            durability=self.config.durability,
            recoveries=len(self._recoveries),
            recovery_time_s=sum(r.wall_time_s for r in self._recoveries),
            replayed_batches=sum(r.replayed_batches
                                 for r in self._recoveries),
            recovery_events=[r.to_dict() for r in self._recoveries],
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
                           if self._push and hist else None),
            tiering=(self.hot.stats() if self._tiered and self.hot is not None
                     else None),
            integrity=integrity)

    def _device_bytes(self) -> Optional[dict]:
        """Per-component device-resident bytes (the memory audit)."""
        if self._closed:
            return None
        if self._walk:
            return {"ranks": self.R.nbytes + self.valid.nbytes,
                    "walk_buffers": self.walks.nbytes}
        if self.inc is None:
            g = self.g
            return {
                "ranks": self.R.nbytes + self.valid.nbytes,
                "graph_snapshot": sum(
                    getattr(g, f.name).nbytes for f in dataclasses.fields(g)
                    if isinstance(getattr(g, f.name), torch.Tensor)),
            }
        mat = self.inc.mat
        # tiered: the view holds no dense tiles (tile_pool 0), the packed
        # slab is packed_index, and rb_res joins the slot tables
        return {
            "ranks": self.R.nbytes + self.valid.nbytes,
            "tile_pool": mat.tiles.nbytes,
            "packed_index": mat.index.nbytes,
            "slot_tables": (mat.tile_cols.nbytes + mat.tile_idx.nbytes
                            + (self.hot.rb_res.nbytes if self._tiered
                               else 0)),
            "operand_mirrors": (self._out_deg.nbytes + self._rb_in.nbytes
                                + self._rb_out.nbytes + self._bmat.nbytes),
            "residual": (self._residual.nbytes if self._residual is not None
                         else 0),
        }
