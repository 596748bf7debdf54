"""Distributed Dynamic-Frontier PageRank over logical shards (ports
``src/repro/core/distributed.py``).

1-D vertex partition: shard d owns the contiguous vertex range
``[d·n_loc, (d+1)·n_loc)``.  Each shard holds its in-edges as a
block-sparse pull matrix (:class:`~repro_torch.kernels.block_spmv.ops.
BlockSparse`: rows its own vertices, padded to the block size; columns the
whole vertex space; one 1 per in-edge, self-loops included), its slice of
the ranks, the affected and still-unconverged flags, and its slices of the
degree vectors.  One sweep:

    1. contribution exchange — one of
         "full"  : every shard's chunk of R/outdeg, concatenated
         "bf16"  : the same, cast to bf16 before the copy and back after it
         "delta" : each shard sends the ≤K entries that changed since the
                   last exchange as (index, value) pairs (``torch.topk`` of
                   |Δ|), patched into every shard's private copy of the last
                   exchanged vector; an overflow anywhere falls back to the
                   full concatenation
         "ring"  : n_dev hops; hop k adds the partial product of the chunk
                   of owner (d − k) mod n_dev (``run_distributed`` only)
    2. the pull of the shard's affected vertices: kernel #1 (``sum``) over
       its matrix, Jacobi, or ``local_gs_sweeps`` > 1 block-Gauss–Seidel
       sweeps against stale remote contributions;
    3. frontier expansion: kernel #1 in the ``or`` semiring over the same
       matrix, applied to the concatenated ``changed`` indicator
       (``A[v, u] ≠ 0`` exactly when u → v, so it marks the out-neighbours
       of every changed vertex);
    4. convergence: the shards' still-unconverged counts summed, read on
       the host once per sweep together with the overflow flag and the
       edge count.

The reference runs this as one ``shard_map`` program over a JAX device
mesh; here the shards are logical (a :class:`ShardMesh` names one
``torch.device`` per shard, in the session all the same card) and every
collective is an explicit copy or reduction over the shards' tensors:
``all_gather`` a concatenation, ``pmax`` of marks an OR, ``psum`` a sum.
The pull and the expansion launch the hand-written tile-SpMV kernel on a
CUDA tensor and its plain version on a CPU tensor: never ``index_add_``,
whose f64 atomics on the card sum in no fixed order, so a replayed drive
is bit for bit the same.  The delta exchange computes the full
concatenation every sweep and selects it on overflow on the device (the
reference's ``lax.cond`` skips it otherwise), so no host read decides a
branch mid-sweep.

Two ways in, as in the reference:

* :class:`DistRuntime` — the incremental runtime behind
  ``PageRankSession(topology="sharded")``: shard matrices and degree
  vectors patched per update batch (``ops.apply_delta``, O(batch) index
  work), one sweep closure per ``expand`` reused across batches;
* :func:`run_distributed` / :func:`build_dist_graph` — the one-shot
  rebuild-everything driver (the ``distributed`` engine adapter and the
  tests call it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.delta import signed_edge_delta
from repro_torch.core.graph import HostGraph
from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.kernels import nvcc
from repro_torch.kernels.block_spmv import ops


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The shards' devices: ``devices[d]`` holds shard d's state.  The
    port's stand-in for the reference's one-axis JAX ``Mesh``."""
    devices: Tuple[torch.device, ...]

    @classmethod
    def on(cls, device, n_shards: int) -> "ShardMesh":
        """``n_shards`` logical shards, all on ``device``."""
        if int(n_shards) <= 0:
            raise ValueError(f"n_shards={n_shards} must be > 0")
        return cls((resolve_device(device),) * int(n_shards))

    @property
    def n_dev(self) -> int:
        return len(self.devices)


def _loop_edges(hg: HostGraph) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) of the graph's edges plus one self-loop per vertex."""
    e = hg.edges
    loops = np.arange(hg.n, dtype=np.int64)
    return (np.concatenate([e[:, 0], loops]),
            np.concatenate([e[:, 1], loops]))


@dataclasses.dataclass
class DistGraph:
    """Shard-partitioned dynamic-graph state, host-built: per shard d its
    pull matrix and the slices ``[d·n_loc, (d+1)·n_loc)`` of the in- and
    out-degree vectors (self-loops counted), of 1/outdeg (0 on padding) and
    of the valid mask, on ``devices[d]``.  ``ring_mats[d][o]`` (ring
    exchange only) is shard d's matrix restricted to the columns of owner
    o's vertices, or ``None`` where no edge runs from o to d."""
    n: int
    n_pad: int
    n_dev: int
    mats: List[ops.BlockSparse]
    in_deg: List[torch.Tensor]        # [n_loc] int32
    out_deg: List[torch.Tensor]       # [n_loc] int32
    inv_deg: List[torch.Tensor]       # [n_loc] rank dtype
    vertex_valid: List[torch.Tensor]  # [n_loc] bool
    ring_mats: Optional[List[List[Optional[ops.BlockSparse]]]] = None

    @property
    def n_loc(self) -> int:
        return self.n_pad // self.n_dev

    @property
    def dtype(self) -> torch.dtype:
        return self.inv_deg[0].dtype

    def clone(self) -> "DistGraph":
        """A copy sharing no storage (``apply_delta`` and the degree patches
        write in place)."""
        return dataclasses.replace(
            self, mats=[m.clone() for m in self.mats],
            in_deg=[t.clone() for t in self.in_deg],
            out_deg=[t.clone() for t in self.out_deg],
            inv_deg=[t.clone() for t in self.inv_deg],
            vertex_valid=list(self.vertex_valid),
            ring_mats=(None if self.ring_mats is None else
                       [[None if m is None else m.clone() for m in row]
                        for row in self.ring_mats]))


def build_dist_graph(hg: HostGraph, mesh: ShardMesh, *,
                     dtype=torch.float32, ring: bool = False,
                     block: int = 64) -> DistGraph:
    """Partition ``hg`` (self-loops added) over ``mesh``'s shards: each
    shard's in-edges by destination owner, as a capacity-padded
    ``BlockSparse`` of ``block``-sized tiles on the shard's device."""
    dt = as_torch_dtype(dtype)
    n, n_dev = hg.n, mesh.n_dev
    n_loc = -(-n // n_dev)
    n_pad = n_loc * n_dev
    src, dst = _loop_edges(hg)
    out_deg = np.bincount(src, minlength=n_pad)
    in_deg = np.bincount(dst, minlength=n_pad)
    vv = np.zeros(n_pad, dtype=bool)
    vv[:n] = True
    inv = np.where(vv, 1.0 / np.maximum(out_deg, 1), 0.0)

    def runs(owner: np.ndarray, groups: int):
        order = np.argsort(owner, kind="stable")
        bounds = np.searchsorted(owner[order], np.arange(groups + 1))
        return order, bounds

    order, bounds = runs(dst // n_loc, n_dev)
    s_in, d_in = src[order], dst[order]
    mats, ind, outd, invd, vvd = [], [], [], [], []
    for d, dev in enumerate(mesh.devices):
        lo, hi = bounds[d], bounds[d + 1]
        sl = slice(d * n_loc, (d + 1) * n_loc)
        mats.append(ops.build_block_sparse(
            d_in[lo:hi] - d * n_loc, s_in[lo:hi], n_loc, n_pad, block=block,
            dtype=dt, padded=True, device=dev))
        ind.append(torch.tensor(in_deg[sl], dtype=torch.int32, device=dev))
        outd.append(torch.tensor(out_deg[sl], dtype=torch.int32, device=dev))
        invd.append(torch.tensor(inv[sl], dtype=dt, device=dev))
        vvd.append(torch.tensor(vv[sl], device=dev))

    ring_mats = None
    if ring:
        # per (destination shard, source owner) matrices for the ring hops
        key = (dst // n_loc) * n_dev + src // n_loc
        order, bounds = runs(key, n_dev * n_dev)
        s_k, d_k = src[order], dst[order]
        ring_mats = [[None] * n_dev for _ in range(n_dev)]
        for k in np.nonzero(np.diff(bounds))[0]:
            d, o = divmod(int(k), n_dev)
            lo, hi = bounds[k], bounds[k + 1]
            ring_mats[d][o] = ops.build_block_sparse(
                d_k[lo:hi] - d * n_loc, s_k[lo:hi] - o * n_loc, n_loc,
                n_loc, block=block, dtype=dt, device=mesh.devices[d])
    return DistGraph(n=n, n_pad=n_pad, n_dev=n_dev, mats=mats,
                     in_deg=ind, out_deg=outd, inv_deg=invd,
                     vertex_valid=vvd, ring_mats=ring_mats)


def _gather(chunks: Sequence[torch.Tensor], mesh: ShardMesh
            ) -> List[torch.Tensor]:
    """``all_gather``: the shards' chunks concatenated, one copy on each
    shard's device (one tensor shared by the shards of one device)."""
    dev0 = mesh.devices[0]
    full = torch.cat([c.to(dev0) for c in chunks])
    return [full.to(dev) for dev in mesh.devices]


def _split(t: torch.Tensor, mesh: ShardMesh, n_loc: int
           ) -> List[torch.Tensor]:
    """A global [n_pad] tensor cut into the shards' chunks, each on its
    shard's device."""
    return [t[d * n_loc:(d + 1) * n_loc].to(dev)
            for d, dev in enumerate(mesh.devices)]


def make_sweep(mesh: ShardMesh, *, n: int, n_loc: int, alpha: float,
               tau: float, tau_f: float, expand: bool,
               exchange: str = "full", delta_capacity: int = 1024,
               local_gs_sweeps: int = 1):
    """The sweep as a closure ``sweep(dg, R, aff, rc, cache)`` over lists
    of per-shard tensors (``cache``: each shard's [n_pad] copy of the last
    exchanged contributions under ``delta``, else ``None``).  Returns
    ``(R, aff, rc, cache, stats)``, ``stats`` an int64 tensor
    (still-unconverged vertices, overflow, in-edges of affected
    destinations) on the first shard's device.  The graph is an argument,
    as the reference's compiled sweep takes its slabs, so one closure
    serves every batch and every fork."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange={exchange!r}; expected one of "
                         f"{EXCHANGES}")
    n_dev = mesh.n_dev
    n_pad = n_loc * n_dev
    base = (1.0 - alpha) / n
    cap = min(delta_capacity, n_loc)
    devs = mesh.devices
    dev0 = devs[0]

    def local_update(dg, d, R_d, act, cf):
        """One (or ``local_gs_sweeps``) pulls of shard d's affected rows;
        between inner sweeps its own slice of ``cf`` is refreshed."""
        off = d * n_loc
        for k in range(max(local_gs_sweeps, 1)):
            pulled = ops.block_spmv(dg.mats[d], cf)
            R_d = torch.where(act, base + alpha * pulled, R_d)
            if k + 1 < local_gs_sweeps:
                cf = cf.clone()
                cf[off:off + n_loc] = R_d * dg.inv_deg[d]
        return R_d

    def delta_exchange(contrib, cache):
        gidx, gval, ovf = [], [], []
        for d in range(n_dev):
            off = d * n_loc
            delta = contrib[d] - cache[d][off:off + n_loc]
            ovf.append(((delta != 0).sum() > cap).reshape(1))
            mag, pos = torch.topk(delta.abs(), cap)
            live = mag > 0
            gidx.append(torch.where(live, pos + off, n_pad))
            gval.append(torch.where(live, contrib[d][pos],
                                    torch.zeros_like(mag)))
        all_idx, all_val = _gather(gidx, mesh), _gather(gval, mesh)
        any_ovf = [o.any() for o in _gather(ovf, mesh)]
        full = _gather(contrib, mesh)
        out = []
        for d in range(n_dev):
            patched = torch.cat([cache[d], cache[d].new_zeros(1)])
            patched[all_idx[d]] = all_val[d]
            # overflow anywhere: the full concatenation (every shard agrees)
            out.append(torch.where(any_ovf[d], full[d], patched[:n_pad]))
        return out, any_ovf[0]

    def sweep(dg: DistGraph, R, aff, rc, cache):
        vv = dg.vertex_valid
        act = [aff[d] & vv[d] for d in range(n_dev)]
        # frontier-proportional work: in-edges (self-loops included) whose
        # destination is in this sweep's affected set
        edges = [torch.where(aff[d], dg.in_deg[d], 0).sum()
                 for d in range(n_dev)]
        contrib = [R[d] * dg.inv_deg[d] for d in range(n_dev)]
        overflow = None
        if exchange == "ring":
            R_new = []
            for d in range(n_dev):
                acc = torch.zeros_like(R[d])
                for k in range(n_dev):
                    o = (d - k) % n_dev
                    m = dg.ring_mats[d][o]
                    if m is not None:
                        acc = acc + ops.block_spmv(m, contrib[o].to(devs[d]))
                R_new.append(torch.where(act[d], base + alpha * acc, R[d]))
        else:
            if exchange == "full":
                full = _gather(contrib, mesh)
            elif exchange == "bf16":
                wire = [c.to(torch.bfloat16) for c in contrib]
                full = [f.to(dg.dtype) for f in _gather(wire, mesh)]
            else:
                full, overflow = delta_exchange(contrib, cache)
            R_new = [local_update(dg, d, R[d], act[d], full[d])
                     for d in range(n_dev)]
        aff_new, rc_new, changed = [], [], []
        for d in range(n_dev):
            dr = (R_new[d] - R[d]).abs()
            changed.append(aff[d] & (dr > tau_f))
            rc_new.append(torch.where(act[d], dr > tau, rc[d]))
        if expand:
            # marks of the out-neighbours of every changed vertex: the OR
            # semiring over each shard's pull matrix (A[v, u] ≠ 0 iff
            # u → v)
            ch = _gather([c.to(dg.dtype) for c in changed], mesh)
            for d in range(n_dev):
                marks = (ops.block_spmv(dg.mats[d], ch[d], semiring="or")
                         > 0) & vv[d]
                aff_new.append(aff[d] | marks)
                rc_new[d] = rc_new[d] | marks
        else:
            aff_new = list(aff)
        outstanding = sum(r.sum().to(dev0) for r in rc_new)
        edges_total = sum(e.to(dev0) for e in edges)
        ovf = (overflow.to(dev0).long() if overflow is not None
               else torch.zeros((), dtype=torch.int64, device=dev0))
        stats = torch.stack([outstanding, ovf, edges_total])
        cache_new = full if exchange == "delta" else cache
        return R_new, aff_new, rc_new, cache_new, stats

    return sweep


@dataclasses.dataclass
class DistStats:
    sweeps: int = 0
    converged: bool = False
    full_exchanges: int = 0
    delta_exchanges: int = 0
    edges_processed: int = 0      # in-edges with affected dst, summed/sweep


def _count_sweep(stats: DistStats, sv: torch.Tensor, exchange: str) -> bool:
    """Add one sweep's stats vector (one host read); True once converged."""
    outstanding, overflow, edges = sv.tolist()
    stats.sweeps += 1
    stats.edges_processed += int(edges)
    if exchange == "delta" and not overflow:
        stats.delta_exchanges += 1
    else:
        stats.full_exchanges += 1
    if outstanding == 0:
        stats.converged = True
    return stats.converged


def _padded(t, n_pad: int, dtype, device) -> torch.Tensor:
    """``t`` as a [n_pad] tensor on ``device``: cut, or zero-padded."""
    t = torch.as_tensor(t, device=device).to(dtype)[:n_pad]
    if t.shape[0] < n_pad:
        t = torch.cat([t, t.new_zeros(n_pad - t.shape[0])])
    return t


def run_distributed(hg_or_dg, mesh: ShardMesh, *, r_prev=None,
                    affected0=None, alpha: float = 0.85, tau: float = 1e-10,
                    tau_f: Optional[float] = None, expand: bool = True,
                    exchange: str = "full", delta_capacity: int = 1024,
                    local_gs_sweeps: int = 1, max_sweeps: int = 500,
                    marks_dtype=torch.int32, dtype=torch.float64,
                    block: int = 64) -> Tuple[torch.Tensor, DistStats]:
    """Converge the distributed DF sweep to all-RC-clear.  Returns the
    ranks ([n_pad], on the first shard's device) and the counters.
    ``marks_dtype`` is the reference's wire type of the frontier marks
    (int8 is its compressed variant); the shards here exchange the marks
    as the tile dtype, so it changes no result."""
    del marks_dtype
    dt = as_torch_dtype(dtype)
    if isinstance(hg_or_dg, DistGraph):
        dg = hg_or_dg
    else:
        dg = build_dist_graph(hg_or_dg, mesh, dtype=dt,
                              ring=(exchange == "ring"), block=block)
    if tau_f is None:
        tau_f = tau / 1000.0 if expand else float("inf")
    dev0 = mesh.devices[0]
    valid = torch.cat([v.to(dev0) for v in dg.vertex_valid])
    R = (torch.full((dg.n_pad,), 1.0 / dg.n, dtype=dt, device=dev0)
         if r_prev is None else _padded(r_prev, dg.n_pad, dt, dev0))
    R = torch.where(valid, R, torch.zeros((), dtype=dt, device=dev0))
    aff = (valid if affected0 is None
           else _padded(affected0, dg.n_pad, torch.bool, dev0) & valid)
    Rs = _split(R, mesh, dg.n_loc)
    affs = _split(aff, mesh, dg.n_loc)
    rcs = affs
    cache = ([torch.zeros(dg.n_pad, dtype=dt, device=dev)
              for dev in mesh.devices] if exchange == "delta" else None)
    sweep = make_sweep(mesh, n=dg.n, n_loc=dg.n_loc, alpha=alpha, tau=tau,
                       tau_f=tau_f, expand=expand, exchange=exchange,
                       delta_capacity=delta_capacity,
                       local_gs_sweeps=local_gs_sweeps)
    stats = DistStats()
    for _ in range(max_sweeps):
        Rs, affs, rcs, cache, sv = sweep(dg, Rs, affs, rcs, cache)
        if _count_sweep(stats, sv, exchange):
            break
    return torch.cat([r.to(dev0) for r in Rs]), stats


# ---------------------------------------------------------------------------
# Topology plumbing for the session API
# ---------------------------------------------------------------------------

EXCHANGES = ("full", "bf16", "delta", "ring")
# exchanges the incremental runtime supports (ring needs the per-owner
# matrices re-grouped on every batch — rebuild-only, excluded from sessions)
SESSION_EXCHANGES = ("full", "bf16", "delta")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Topology request handed from ``EngineConfig`` to the distributed
    engine / runtime: how many shards, which partitioner relabels the
    vertex space, and which contribution exchange runs per sweep."""
    n_shards: int
    partitioner: str = "contiguous"
    exchange: str = "full"
    delta_capacity: int = 1024


class _EdgeLog:
    """The host edge set (self-loops excluded) that
    :meth:`DistRuntime.registered_edges` and :meth:`DistRuntime.shrink`
    read: a :class:`HostGraph` plus the batches logged since it was last
    read, O(batch) each.  A read folds the log in one pass: an edge's last
    event decides, since the batches are effective (a deletion removes a
    present edge, an insertion adds an absent one).  The log is also
    folded once it outgrows the edge set, so it stays bounded and a fold
    costs O(1) a logged edge, amortized."""

    def __init__(self, hg: HostGraph):
        self._hg = hg
        self._log: list = []          # (keys, inserted), in batch order
        self._logged = 0

    def log(self, dels: np.ndarray, ins: np.ndarray) -> None:
        n = np.int64(self._hg.n)
        for e, inserted in ((dels, False), (ins, True)):
            e = e[e[:, 0] != e[:, 1]]
            if len(e):
                self._log.append((e[:, 0] * n + e[:, 1], inserted))
                self._logged += len(e)
        if self._logged > max(self._hg.m, 1 << 16):
            self.graph()

    def graph(self) -> HostGraph:
        if self._log:
            keys = np.concatenate([k for k, _ in self._log])[::-1]
            inserted = np.concatenate(
                [np.full(len(k), i) for k, i in self._log])[::-1]
            touched, last = np.unique(keys, return_index=True)
            old = self._hg._keys
            kept = old[~np.isin(old, touched, assume_unique=True)]
            g = HostGraph.__new__(HostGraph)
            g.n, g._keys = self._hg.n, np.union1d(kept,
                                                  touched[inserted[last]])
            self._hg, self._log, self._logged = g, [], 0
        return self._hg

    def fork(self) -> "_EdgeLog":
        new = _EdgeLog(self._hg)
        new._log, new._logged = list(self._log), self._logged
        return new


class DistRuntime:
    """Incrementally maintained sharded DF_LF runtime: each shard's pull
    matrix and degree slices stay on its device and are patched per update
    batch (``ops.apply_delta``, O(batch) index work, never an O(m)
    rebuild), and one sweep closure per ``expand`` is built once and
    re-entered for every batch.  ``cache_size`` counts kernel-library
    builds, as the session's ``driver_retraces`` does.

    Vertex ids are in the runtime's own (partitioner-relabeled) space; the
    session layer owns the relabeling.  The vertex set is fixed for the
    runtime's lifetime."""

    def __init__(self, hg: HostGraph, mesh: ShardMesh, *,
                 alpha: float = 0.85, tau: float = 1e-10,
                 tau_f: Optional[float] = None, exchange: str = "full",
                 delta_capacity: int = 1024, dtype=torch.float64,
                 block: int = 64):
        if exchange not in SESSION_EXCHANGES:
            raise ValueError(
                f"exchange={exchange!r} is not supported by the incremental "
                f"runtime; expected one of {SESSION_EXCHANGES}")
        self.mesh = mesh
        n_dev = mesh.n_dev
        n = hg.n
        n_loc = -(-n // n_dev)
        self.n, self.n_dev, self.n_loc, self.n_pad = n, n_dev, n_loc, \
            n_loc * n_dev
        self.dtype = as_torch_dtype(dtype)
        self.exchange = exchange
        self.delta_capacity = delta_capacity
        self.block = block
        self._alpha = float(alpha)
        self._tau = float(tau)
        self._tau_f = (float(tau_f) if tau_f is not None else tau / 1000.0)
        self._sweeps: dict = {}
        self._edges = _EdgeLog(hg)
        self.dg = build_dist_graph(hg, mesh, dtype=self.dtype, block=block)
        dev0 = mesh.devices[0]
        self._valid = torch.cat([v.to(dev0) for v in self.dg.vertex_valid])
        # the delta exchange's per-shard copy of the last exchanged
        # contributions persists across drives (zeros before the first)
        self._cache = ([torch.zeros(self.n_pad, dtype=self.dtype, device=dev)
                        for dev in mesh.devices]
                       if exchange == "delta" else None)

    @property
    def valid(self) -> torch.Tensor:
        """[n_pad] valid-vertex mask on the first shard's device."""
        return self._valid

    # -- O(batch) delta application -----------------------------------------
    def apply_batch(self, dels: np.ndarray, ins: np.ndarray) -> None:
        """Route one *effective* (deletions, insertions) batch to its
        owning shards: the host edge log, then per touched shard
        one ``apply_delta`` of its matrix (rows ``dst − off``, columns
        ``src``), and the degree slices patched at the touched vertices
        (integer scatters, then 1/outdeg re-read at the sources)."""
        dels = np.asarray(dels, np.int64).reshape(-1, 2)
        ins = np.asarray(ins, np.int64).reshape(-1, 2)
        self._edges.log(dels, ins)
        rows, cols, vals = signed_edge_delta(dels, ins)
        if not len(rows):
            return
        dg, n_loc = self.dg, self.n_loc
        for d in np.unique(rows // n_loc).tolist():
            sel = rows // n_loc == d
            dev = self.mesh.devices[d]
            dg.mats[d] = ops.apply_delta(dg.mats[d], rows[sel] - d * n_loc,
                                         cols[sel], vals[sel])
            dg.in_deg[d].index_add_(
                0, ops._upload(rows[sel] - d * n_loc, dev),
                ops._upload(vals[sel].astype(np.int32), dev))
        for d in np.unique(cols // n_loc).tolist():
            sel = cols // n_loc == d
            dev = self.mesh.devices[d]
            idx = ops._upload(cols[sel] - d * n_loc, dev)
            dg.out_deg[d].index_add_(
                0, idx, ops._upload(vals[sel].astype(np.int32), dev))
            deg = dg.out_deg[d][idx].clamp(min=1).to(self.dtype)
            dg.inv_deg[d][idx] = torch.where(
                dg.vertex_valid[d][idx], 1.0 / deg, torch.zeros_like(deg))

    def mask_from_indices(self, idx: np.ndarray) -> torch.Tensor:
        """[n_pad] indicator of a vertex-index list (only the list crosses
        to the device, never the graph-sized vector)."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        dev0 = self.mesh.devices[0]
        ind = torch.zeros(self.n_pad + 1, dtype=torch.bool, device=dev0)
        if len(idx):
            ind[ops._upload(np.minimum(idx, self.n_pad), dev0)] = True
        return ind[:self.n_pad] & self._valid

    # -- the reused sweep -----------------------------------------------------
    def _sweep_for(self, expand: bool):
        key = bool(expand)
        if key not in self._sweeps:
            self._sweeps[key] = make_sweep(
                self.mesh, n=self.n, n_loc=self.n_loc, alpha=self._alpha,
                tau=self._tau,
                tau_f=(self._tau_f if expand else float("inf")),
                expand=expand, exchange=self.exchange,
                delta_capacity=self.delta_capacity)
        return self._sweeps[key]

    def drive(self, R, affected, *, expand: bool, max_sweeps: int = 500,
              rc0=None, collect_state: bool = False):
        """Converge one (R, affected) problem through the cached sweep.
        Ranks stay on the devices; each sweep reads one stats vector on the
        host.  ``rc0`` seeds the still-unconverged flags (default: the
        affected set); ``collect_state=True`` also returns the final
        ``(affected, rc)`` masks so a caller can suspend a drive and resume
        it.  Returns ``(R, stats)`` or ``(R, stats, (aff, rc))``, ``R``
        and the masks [n_pad] on the first shard's device."""
        sweep = self._sweep_for(expand)
        mesh, n_loc = self.mesh, self.n_loc
        dev0 = mesh.devices[0]
        R = _padded(R, self.n_pad, self.dtype, dev0)
        R = torch.where(self._valid, R,
                        torch.zeros((), dtype=self.dtype, device=dev0))
        aff = _padded(affected, self.n_pad, torch.bool, dev0) & self._valid
        Rs, affs = _split(R, mesh, n_loc), _split(aff, mesh, n_loc)
        rcs = (affs if rc0 is None else _split(
            _padded(rc0, self.n_pad, torch.bool, dev0) & self._valid,
            mesh, n_loc))
        cache = self._cache
        stats = DistStats()
        for _ in range(max_sweeps):
            Rs, affs, rcs, cache, sv = sweep(self.dg, Rs, affs, rcs, cache)
            if _count_sweep(stats, sv, self.exchange):
                break
        self._cache = cache
        R = torch.cat([r.to(dev0) for r in Rs])
        if collect_state:
            return R, stats, (torch.cat([a.to(dev0) for a in affs]),
                              torch.cat([r.to(dev0) for r in rcs]))
        return R, stats

    # -- shard topology -------------------------------------------------
    def owned_range(self, shard: int) -> Tuple[int, int]:
        """[lo, hi) of real vertex ids (runtime-relabeled space) owned by
        ``shard`` under the contiguous layout."""
        lo = shard * self.n_loc
        return lo, min((shard + 1) * self.n_loc, self.n)

    def registered_edges(self) -> np.ndarray:
        """The edge set (self-loops excluded) of the host edge log — what a
        re-partition after a shard loss rebuilds from."""
        return self._edges.graph().edges

    def shrink(self, dead: int) -> "DistRuntime":
        """Re-partition onto the surviving ``n_dev − 1`` shards after a
        permanent loss of shard ``dead``, the shard matrices rebuilt from
        the host edge log (no state of the old shards is read).  The
        vertex relabeling is untouched; only the contiguous split
        changes."""
        if self.n_dev <= 1:
            raise ValueError("cannot shrink a 1-shard runtime")
        if not (0 <= dead < self.n_dev):
            raise ValueError(f"dead shard {dead} out of range "
                             f"(n_dev={self.n_dev})")
        mesh = ShardMesh(tuple(dev for i, dev in enumerate(self.mesh.devices)
                               if i != dead))
        return DistRuntime(
            self._edges.graph(), mesh,
            alpha=self._alpha, tau=self._tau, tau_f=self._tau_f,
            exchange=self.exchange, delta_capacity=self.delta_capacity,
            dtype=self.dtype, block=self.block)

    def warmup(self, R) -> None:
        """Run the per-batch pipeline once without perturbing graph or rank
        state (an empty batch, an empty seed, two one-sweep drives), so the
        kernel library is built and loaded before the first update."""
        empty = np.zeros((0, 2), np.int64)
        self.apply_batch(empty, empty)
        aff = self.mask_from_indices(np.zeros(0, np.int64))
        self.drive(R, aff, expand=True, max_sweeps=1)
        self.drive(R, aff, expand=True, max_sweeps=1)

    def cache_size(self) -> int:
        """Kernel-library builds of the process (the port's counterpart of
        the reference's jit-cache entries)."""
        return nvcc.total_builds()

    def fork(self) -> "DistRuntime":
        """An independent twin: the shard matrices and degree slices (which
        updates patch in place) and the host bookkeeping are copied; the
        sweep closures and the delta cache (replaced, never written in
        place) are shared."""
        new = object.__new__(DistRuntime)
        new.__dict__.update(self.__dict__)
        new._edges = self._edges.fork()
        new.dg = self.dg.clone()
        new._sweeps = dict(self._sweeps)
        new._cache = None if self._cache is None else list(self._cache)
        return new


def df_seed_indices(hg_prev: HostGraph, hg_cur: HostGraph,
                    sources: np.ndarray) -> np.ndarray:
    """Paper Alg. 1 lines 4-6 on the host in O(batch · deg): the
    out-neighbors of every update source in G^{t-1} **and** G^t, plus the
    sources themselves (every device graph carries per-vertex self-loops,
    so a source is its own out-neighbor, as in
    :func:`repro_torch.core.frontier.initial_affected`)."""
    sources = np.unique(np.asarray(sources, np.int64).reshape(-1))
    sources = sources[(sources >= 0) & (sources < hg_cur.n)]
    out = [sources]
    for hg in (hg_prev, hg_cur):
        keys = hg._keys
        n = np.int64(hg.n)
        lo = np.searchsorted(keys, sources * n)
        hi = np.searchsorted(keys, (sources + 1) * n)
        for k0, k1 in zip(lo.tolist(), hi.tolist()):
            if k1 > k0:
                out.append(keys[k0:k1] % n)
    return np.unique(np.concatenate(out)) if out else sources


def collective_bytes_per_sweep(*, n_pad: int, n_dev: int, exchange: str,
                               rank_bytes: int, marks_bytes: int = 4,
                               delta_capacity: int = 1024,
                               expand: bool = True,
                               frac_full: float = 1.0) -> float:
    """Analytic wire-traffic model for one sweep, summed over shards: the
    number the partitioner and exchange choice control on a real
    interconnect (the logical shards of one card copy within its memory).

    Contribution exchange: every shard ships its n_loc chunk to the other
    n_dev−1 shards (`full`: rank_bytes an entry; `bf16`: 2 bytes; `delta`:
    (4-byte index + value) × delta_capacity, with `frac_full` of the sweeps
    falling back to the full exchange on overflow).  Frontier expansion
    adds one all-reduce of the [n_pad] mark vector.  The scalar reductions
    are negligible and omitted."""
    n_loc = n_pad // max(n_dev, 1)
    pairs = n_dev * (n_dev - 1)
    gather_full = pairs * n_loc * rank_bytes
    if exchange == "full":
        g = gather_full
    elif exchange == "bf16":
        g = pairs * n_loc * 2
    elif exchange == "delta":
        g_delta = pairs * delta_capacity * (4 + rank_bytes)
        g = frac_full * gather_full + (1.0 - frac_full) * g_delta
    else:
        raise ValueError(f"exchange={exchange!r}; "
                         f"expected one of {SESSION_EXCHANGES}")
    marks = pairs * n_pad * marks_bytes if expand else 0
    return float(g + marks)


# ---------------------------------------------------------------------------
# engine adapter (Engine protocol; discovered lazily by
# repro_torch.api.registry so this module never imports the api package)
# ---------------------------------------------------------------------------

class DistributedEngine:
    """Registry adapter of the sharded stale-synchronous engine: a one-shot
    solve that partitions the snapshot over logical shards on the
    snapshot's device.  Sessions with ``topology="sharded"`` drive
    :class:`DistRuntime` directly; the adapter is the snapshot-level
    surface.  With no ``shards`` it runs one shard (the reference takes
    every visible JAX device)."""

    name = "distributed"
    fault_domains = ("shard", "process")

    def run(self, g, R0, affected0, *, mode, expand, alpha, tau, tau_f,
            max_iterations, faults, tile, active_policy,
            mat=None, aux=None, backend=None, shards=None):
        from repro_torch.api.registry import reject_tile_operands
        from repro_torch.core.blocked import SweepStats
        from repro_torch.graphs import partition as gpart
        reject_tile_operands(self.name, mat, aux, backend)
        del mode, tile, active_policy   # single-device knobs: the sharded
        # sweep is stale-synchronous block-Jacobi by design
        if faults is not None:
            raise ValueError(
                "fault simulation is not supported by engine='distributed' "
                "(stragglers are the model: stale contributions, no crash "
                "tables) — use engine='blocked'/'pallas' with a FaultPlan")
        spec = shards if shards is not None else ShardSpec(n_shards=1)
        src, dst = g.in_edges_host()
        hg = HostGraph(g.n, np.stack([src, dst], 1))
        order, _, _ = gpart.make_partition(hg, spec.n_shards,
                                           spec.partitioner)
        hg_rel, _ = gpart.relabel(hg, order)
        mesh = ShardMesh.on(g.device, spec.n_shards)
        n_pad_rel = -(-g.n // spec.n_shards) * spec.n_shards
        R0h = torch.as_tensor(R0).cpu().numpy()
        r_rel = np.zeros(n_pad_rel, R0h.dtype)
        r_rel[:g.n] = R0h[order]
        affh = torch.as_tensor(affected0).cpu().numpy()[:g.n_pad]
        a_rel = np.zeros(n_pad_rel, bool)
        a_rel[:g.n] = affh[order]
        R, st = run_distributed(
            hg_rel, mesh, r_prev=torch.from_numpy(r_rel),
            affected0=torch.from_numpy(a_rel), alpha=alpha, tau=tau,
            tau_f=tau_f, expand=expand, exchange=spec.exchange,
            delta_capacity=spec.delta_capacity, max_sweeps=max_iterations,
            dtype=R0h.dtype, block=g.block_size)
        Rh = R.cpu().numpy()
        out = np.zeros(g.n_pad, Rh.dtype)
        out[order] = Rh[:g.n]
        stats = SweepStats(sweeps=st.sweeps, iterations=st.sweeps,
                           edges_processed=st.edges_processed,
                           converged=st.converged)
        return torch.from_numpy(out).to(g.device), stats


def as_engine() -> DistributedEngine:
    return DistributedEngine()
