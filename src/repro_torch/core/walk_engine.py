"""Monte Carlo walk engine — sweep-free (personalized) PageRank (ports
``src/repro/core/walk_engine.py``).

The engine state is ``R`` walk segments of at most ``L`` vertices per
vertex (``walks [n*R+1, L]`` int32, the sentinel ``n`` past a walk's end)
and a per-vertex visit counter folded incrementally.  A walk continues with
probability ``alpha`` and picks a uniform out-neighbour, the implicit
self-loop included; ``PR(u) ≈ X_u (1-α) / (nR)`` over all walks, and
``PPR_S(u)`` the same over the walks started at the seeds ``S``.  Every
draw of a walk comes from ``fold_in(PRNGKey(seed), walk id)``
(:mod:`repro_torch.core.threefry`, the reference's threefry bit for bit)
and adjacency rows are kept sorted, so an update regenerates only the walks
that visit a touched vertex, incremental equals full regeneration, a
delete and reinsert restores the buffers, and the port's buffers, counts,
estimates and ``WalkUpdateStats`` equal the reference's exactly.

Where the port differs:

* the walks an update touches are found by one pass over the walk buffer on
  the device (:func:`repro_torch.kernels.walk.walk.walk_touch`), not a host
  reverse index: the same set and the same touched-walk mass, without the
  index's O(n·R·L) host build (about 1.1e8 entries at n = 1M);
* the regeneration list is not padded onto ``WALK_BATCH_BUCKET``'s ladder
  (the kernel takes any length); the stats still report the reference's
  ``batch_bucket`` and ``new_bucket``, computed as it does;
* the buffers are patched in place, so :meth:`WalkState.fork` copies them.
"""
from __future__ import annotations

import dataclasses
from typing import Set, Tuple

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.blocked import SweepStats
from repro_torch.core.graph import HostGraph
from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.kernels.block_spmv import ops
from repro_torch.kernels.walk import walk as wk

# Capacity-ladder bases (doubling discipline; see ops.capacity_bucket).
WALK_BATCH_BUCKET = 64     # regeneration batch floor (reported, not padded)
ADJ_SLOT_BASE = 8          # per-vertex adjacency slab-width floor
# the reference's DELTA_BATCH_BUCKET: the floor of its adjacency-scatter
# ladder, which the stats' ``new_bucket`` follows
DELTA_BATCH_BUCKET = 64

# Defaults EngineConfig resolves its None walk fields to.
DEFAULT_WALKS_PER_VERTEX = 16
DEFAULT_WALK_LENGTH = 48
DEFAULT_WALK_SEED = 0


def cache_size() -> int:
    """Kernel-library loads of the walk kernels in this process: the port's
    counterpart of the reference's jit-cache count (1 after the first CUDA
    launch, 0 on the CPU)."""
    return wk.builds()


def _scale(alpha32: float, walks: int, dtype: torch.dtype) -> float:
    """The reference's ``(1 - alpha_f32).astype(dtype) / walks`` as XLA
    computes it: the difference in f32, widened to ``dtype``, times the
    reciprocal of the constant ``walks`` in ``dtype`` (XLA's simplifier
    turns a division by a constant into that product)."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    one_minus = np.float32(1.0) - np.float32(alpha32)
    return float(np_dt(one_minus) * (np_dt(1.0) / np_dt(walks)))


def ppr_values(walks: torch.Tensor, seeds: torch.Tensor, *, n: int, R: int,
               alpha32: float, dtype: torch.dtype) -> torch.Tensor:
    """Personalized-PageRank estimate ``[n]`` for a uniform restart over
    ``seeds`` (a seed listed twice counts twice, as in the reference):
    the visit counts of the seeds' own walks times ``(1-α)/(|S|·R)``."""
    rows = (seeds.long()[:, None] * R
            + torch.arange(R, device=walks.device)[None, :]).reshape(-1)
    t = walks[rows].reshape(-1).long().clamp(max=n)
    visits = torch.bincount(t, minlength=n + 1)[:n]
    scale = _scale(alpha32, int(seeds.shape[0]) * R, dtype)
    return visits.to(dtype) * torch.tensor(scale, dtype=dtype,
                                           device=walks.device)


def top_k(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest values, ties lower id first (a stable
    descending sort)."""
    v, i = torch.sort(vals, descending=True, stable=True)
    return v[:k], i[:k]


# ---------------------------------------------------------------------------
# walk store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WalkUpdateStats:
    """Per-delta localization accounting (the acceptance instrument)."""
    touched_vertices: int       # distinct src endpoints of effective edges
    touched_walk_mass: int      # Σ_u |walks visiting u| over touched u
    regenerated_walks: int      # |union| — walks actually rebuilt
    total_walks: int            # n * R
    steps: int                  # walk steps recomputed (work metric)
    batch_bucket: int           # the reference's padded regeneration width
    adj_cap: int                # adjacency slab width after the batch
    new_bucket: bool            # first visit to a ladder bucket this batch


class WalkState:
    """Device-resident Monte Carlo walk store over an incremental
    adjacency.  One instance backs one walk-engine session; ``fork()``
    copies its buffers (they are patched in place) and host twins."""

    def __init__(self, hg: HostGraph, *,
                 R: int = DEFAULT_WALKS_PER_VERTEX,
                 L: int = DEFAULT_WALK_LENGTH,
                 seed: int = DEFAULT_WALK_SEED,
                 alpha: float = 0.85,
                 dtype=torch.float64, device="cuda"):
        if int(R) < 1:
            raise ValueError(f"walks_per_vertex={R} must be >= 1")
        if int(L) < 2:
            raise ValueError(f"walk_length={L} must be >= 2 (a walk is its "
                             "start vertex plus at least one step slot)")
        self.n = int(hg.n)
        self.R = int(R)
        self.L = int(L)
        self.seed = int(seed)
        self.alpha = float(alpha)
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self._key = threefry.prng_key(self.seed)
        self._alpha32 = float(np.float32(self.alpha))
        self.host_syncs = 0             # device-to-host reads of updates
        n, nr = self.n, self.n * self.R

        # -- adjacency slabs: host truth + device mirror ------------------
        # rows are kept SORTED by destination id so a delete+reinsert of
        # the same edge restores the row (and thus every walk through it)
        # bit-for-bit — hg.edges is already (src, dst)-sorted
        src = hg.edges[:, 0].astype(np.int64)
        dst = hg.edges[:, 1].astype(np.int64)
        degs = np.bincount(src, minlength=n).astype(np.int64) if hg.m \
            else np.zeros(n, np.int64)
        self._cap = int(ops.capacity_bucket(max(int(degs.max()) if hg.m
                                                else 1, 1), ADJ_SLOT_BASE))
        self._adj_host = np.full((n + 1, self._cap), n, np.int32)
        self._deg_host = np.zeros(n + 1, np.int32)
        if hg.m:
            col = np.arange(hg.m) - np.repeat(np.cumsum(degs) - degs, degs)
            self._adj_host[src, col] = dst.astype(np.int32)
            self._deg_host[:n] = degs.astype(np.int32)
        self.adj = torch.tensor(self._adj_host, device=self.device)
        self.deg = torch.tensor(self._deg_host, device=self.device)

        # -- walk buffers + counters: generate everything once ------------
        self.walks = torch.full((nr + 1, self.L), n, dtype=torch.int32,
                                device=self.device)
        self.counts = torch.zeros(n + 1, dtype=torch.int32,
                                  device=self.device)
        self._regen(torch.arange(nr, dtype=torch.int32, device=self.device))
        self._buckets: Set[Tuple] = set()   # ladder buckets seen post-init

    def _regen(self, wids: torch.Tensor) -> torch.Tensor:
        return wk.walk_regen(self.walks, self.counts, self.adj, self.deg,
                             wids, R=self.R, alpha=self._alpha32,
                             key=self._key)

    def _see_bucket(self, key: Tuple) -> bool:
        """Record a ladder-bucket visit; True when it is the first."""
        new = key not in self._buckets
        self._buckets.add(key)
        return new

    # -- O(batch) delta application ----------------------------------------
    def apply_batch(self, dels: np.ndarray, ins: np.ndarray
                    ) -> WalkUpdateStats:
        """Apply one **effective** edge batch (``core.incremental.
        effective_batch`` output: every edge genuinely changes the graph)
        and regenerate exactly the walks passing through touched vertices,
        found by one ``walk_touch`` pass over the walk buffer."""
        n, nr = self.n, self.n * self.R
        dev = self.device
        dels = np.asarray(dels, np.int64).reshape(-1, 2)
        ins = np.asarray(ins, np.int64).reshape(-1, 2)
        touched = np.unique(np.concatenate([dels[:, 0], ins[:, 0]])) \
            if (len(dels) + len(ins)) else np.zeros(0, np.int64)
        new_bucket = False
        mass = regen = steps = b_pad = 0

        if touched.size:
            # host patch of the touched rows (sorted-set semantics)
            rows_new = []
            widest = 0
            for uu in touched.tolist():
                row = self._adj_host[uu, :self._deg_host[uu]].astype(
                    np.int64)
                du = dels[dels[:, 0] == uu, 1]
                iu = ins[ins[:, 0] == uu, 1]
                if du.size:
                    row = np.setdiff1d(row, du)
                if iu.size:
                    row = np.union1d(row, iu)
                rows_new.append(row)
                widest = max(widest, row.size)
            if widest > self._cap:      # slab ladder: widen
                self._widen(int(ops.capacity_bucket(widest, ADJ_SLOT_BASE)))
                new_bucket = True
            for uu, row in zip(touched.tolist(), rows_new):
                self._adj_host[uu, :] = n
                self._adj_host[uu, :row.size] = row.astype(np.int32)
                self._deg_host[uu] = row.size
            # device scatter of just the touched rows (the reference pads
            # it onto the DELTA_BATCH_BUCKET ladder; the bucket is recorded)
            b = int(ops.capacity_bucket(touched.size,
                                        DELTA_BATCH_BUCKET))
            if self._see_bucket(("adj", b, self._cap)):
                new_bucket = True
            idx = torch.as_tensor(touched, device=dev)
            self.adj[idx] = torch.as_tensor(self._adj_host[touched],
                                            device=dev)
            self.deg[idx] = torch.as_tensor(self._deg_host[touched],
                                            device=dev)

            # the walks that visit a touched vertex: one buffer pass
            tmap = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            tmap[idx] = True
            flags, mass_t = wk.walk_touch(self.walks, tmap, n_walks=nr)
            wids = flags.nonzero().reshape(-1).to(torch.int32)  # ascending
            regen, mass = int(wids.shape[0]), int(mass_t)
            self.host_syncs += 2
            if regen > mass:    # structurally impossible; guard regardless
                raise AssertionError(
                    f"regenerated-walk count {regen} exceeds the touched-"
                    f"walk mass {mass}: regeneration is no longer "
                    "delta-localized")
            if regen:
                b_pad = int(ops.capacity_bucket(regen, WALK_BATCH_BUCKET))
                if self._see_bucket(("regen", b_pad, self._cap)):
                    new_bucket = True
                steps = int(self._regen(wids))
                self.host_syncs += 1
        return WalkUpdateStats(
            touched_vertices=int(touched.size), touched_walk_mass=mass,
            regenerated_walks=regen, total_walks=nr, steps=steps,
            batch_bucket=b_pad, adj_cap=self._cap, new_bucket=new_bucket)

    def _widen(self, cap_new: int) -> None:
        """Grow the adjacency slab width to the next ladder bucket."""
        wide = np.full((self.n + 1, cap_new), self.n, np.int32)
        wide[:, :self._cap] = self._adj_host
        self._adj_host = wide
        self._cap = cap_new
        self.adj = torch.tensor(wide, device=self.device)

    @property
    def total_steps(self) -> int:
        """Live (non-sentinel) walk positions across every buffer — the
        total step count a full regeneration recomputes."""
        nr = self.n * self.R
        return int((self.walks[:nr] < self.n).sum())

    # -- O(read) queries ----------------------------------------------------
    def pagerank(self) -> torch.Tensor:
        """Global PR estimate [n] from the incrementally folded counters."""
        scale = _scale(self._alpha32, self.n * self.R, self.dtype)
        return self.counts[:self.n].to(self.dtype) * torch.tensor(
            scale, dtype=self.dtype, device=self.device)

    def _seeds(self, seeds) -> torch.Tensor:
        return torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1),
                               device=self.device)

    def ppr(self, seeds) -> torch.Tensor:
        """Full personalized-PageRank estimate [n] for a uniform restart
        over ``seeds`` (int array of vertex ids)."""
        return ppr_values(self.walks, self._seeds(seeds), n=self.n,
                          R=self.R, alpha32=self._alpha32, dtype=self.dtype)

    def ppr_top_k(self, seeds, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(values, vertex ids) of the k highest PPR estimates, ties lower
        id first (``lax.top_k``)."""
        return top_k(self.ppr(seeds), int(k))

    # -- lifecycle -----------------------------------------------------------
    def warmup(self) -> None:
        """Build and load the kernels with an inert regeneration of the
        scratch row ``n*R`` (it starts at the sentinel and stays there) and
        a no-op adjacency scatter to the sentinel row — state is
        untouched.  Records the reference's base buckets."""
        n, nr = self.n, self.n * self.R
        self._regen(torch.full((1,), nr, dtype=torch.int32,
                               device=self.device))
        self._buckets.add(("regen", WALK_BATCH_BUCKET, self._cap))
        self.adj[n] = n
        self.deg[n] = 0
        self._buckets.add(("adj", int(DELTA_BATCH_BUCKET), self._cap))

    def fork(self) -> "WalkState":
        """An independent copy: the device buffers (patched in place by
        updates; +3.26 GB at n = 1M, R = 16, L = 48) and the host twins."""
        new = object.__new__(WalkState)
        new.__dict__.update(self.__dict__)
        new._adj_host = self._adj_host.copy()
        new._deg_host = self._deg_host.copy()
        new._buckets = set(self._buckets)
        for name in ("walks", "counts", "adj", "deg"):
            setattr(new, name, getattr(self, name).clone())
        return new

    @property
    def nbytes(self) -> int:
        """Device bytes of the store: walks, counts, adjacency, degrees."""
        return sum(t.nbytes for t in (self.walks, self.counts, self.adj,
                                      self.deg))


# ---------------------------------------------------------------------------
# repro_torch.api engine adapter (Engine protocol; loaded lazily by the
# registry)
# ---------------------------------------------------------------------------

class WalkEngine:
    """Registry adapter for the Monte Carlo walk engine — the sweep-free
    estimator.  ``supports`` declares the personalization capability the
    config layer gates walk fields on; the snapshot-level ``run`` builds a
    throwaway walk store at the default (R, L, seed) on the snapshot's
    device and returns the global estimate (sessions use
    :class:`WalkState` directly through the walk mode and carry the
    configured parameters)."""

    name = "walk"
    fault_domains = ("process",)
    supports = frozenset({"ppr"})

    def run(self, g, R0, affected0, *, mode="lf", expand=True, alpha=0.85,
            tau=1e-10, tau_f=None, max_iterations=500, faults=None,
            tile=512, active_policy="affected", mat=None, aux=None,
            backend=None, shards=None):
        from repro_torch.api.registry import (reject_shard_spec,
                                              reject_tile_operands)
        reject_tile_operands(self.name, mat, aux, backend)
        reject_shard_spec(self.name, shards)
        if faults is not None:
            raise ValueError(
                "the walk engine hosts no thread fault domain (declares "
                f"{self.fault_domains}); faults must be None")
        st = WalkState(host_graph_of(g), alpha=alpha, dtype=R0.dtype,
                       device=g.device)
        ranks = torch.zeros(g.n_pad, dtype=st.dtype, device=g.device)
        ranks[:g.n] = st.pagerank()
        est_len = min(1.0 / (1.0 - alpha), float(st.L))
        stats = SweepStats(sweeps=1, iterations=1, converged=True,
                           edges_processed=int(g.n * st.R * est_len))
        return ranks, stats


def host_graph_of(g) -> HostGraph:
    """The host graph of a snapshot: its real edges without the
    self-loops the snapshot adds (the walks re-add them by sampling)."""
    src, dst = g.in_edges_host()
    keep = src != dst
    return HostGraph(g.n, np.stack([src[keep], dst[keep]], 1))


def as_engine() -> WalkEngine:
    return WalkEngine()

