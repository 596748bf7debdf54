"""Tiered graph storage — the host tile pool and a budget-bounded device
hot slab, and the blocked engine's paged edges (ports
``src/repro/core/tiering.py``: ``slab_tiles_for_budget``, ``budget_hint``,
``HostTilePool``, ``HotSetManager``, ``host_block_adjacency``,
``EdgeView``, ``EdgePager`` and ``paged_snapshot``).

* :class:`HostTilePool` — the **host tier**: the full tile pool and slot
  tables as numpy arrays (``ops.build_block_sparse(to_device=False)``),
  patched per batch through ``ops.plan_delta`` and one ``np.add.at``.  It is
  the truth that ``save`` and the scrub read, never the slab.
* :class:`HotSetManager` — the **device tier**: the row-blocks the session
  admitted, with the same residency, clock/second-chance eviction,
  frontier-biased admission and counters as the reference.  Its
  :meth:`HotSetManager.view` is an ordinary ``ops.BlockSparse`` whose
  ``tile_idx`` maps each occupied slot of a resident row-block to a slab
  slot, and ``rb_res`` tells the fused driver which row-blocks it may
  update.

The slab differs from the reference's in what it holds.  The reference
keeps dense ``[cap, B, B]`` tiles; the port's kernels read only the packed
index (``ops.PackedIndex``), so the slab is a ``PackedIndex`` keyed by slab
slot — each resident tile's nonzeros in row-major order, as
``ops._pack_tiles`` orders them — and the view's ``tiles`` is a zero-size
placeholder.  Slot 0 is the empty tile (``cnt = 0``) that every
non-resident slot maps to.  Admission packs the admitted tiles on the host
(one ``np.flatnonzero`` per bounded chunk of the gathered tiles) and uploads
only their entries: an entry is 2 bytes of place and one value, a dense
tile ``B·B`` values.  Entries of evicted tiles are left where they are;
when an admission finds no room at the tail, the resident entries are
compacted on the device (and the entry pool grows if they still do not
fit), counted in ``index_repacks`` / ``repacked_entries`` apart from the
reference's counters.

* :class:`EdgePager` — the blocked engine's analogue over per-block edge
  extents: the snapshot's CSR stays on the host and each sweep's active
  blocks are staged into a bounded device slab, which
  :func:`repro_torch.core.blocked.run_blocked` reads through per-block
  ``lo``/``len`` tables (:func:`paged_snapshot` drops the device CSR).

The budget and the counters keep the reference's units: a slab slot is
charged as one B×B dense tile (:func:`slab_tiles_for_budget`), and so are
``transfer_bytes`` and ``slab_bytes``, so admissions, evictions and refill
rounds equal the reference's on the same stream.  ``device_bytes()`` gives
what the slab really allocates.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.kernels.block_spmv import ops

PACK_CHUNK_ELEMS = 1 << 25     # dense tile elements gathered per host step


def slab_tiles_for_budget(budget_bytes: int, block: int, dtype) -> int:
    """Tile capacity of a device slab under ``budget_bytes``: the budget is
    spent on B×B dense tiles (slot tables and the residency indicator are
    index-sized and not charged).  Slot 0 is the reserved empty tile, so
    the usable capacity is one less than what is returned here."""
    tile_bytes = block * block * np.dtype(dtype).itemsize
    return max(int(budget_bytes) // tile_bytes, 0)


def budget_hint(block: int, dtype, *, max_tiles_rb: int) -> str:
    """Sizing rule rendered for error messages."""
    tile_bytes = block * block * np.dtype(dtype).itemsize
    need = (max_tiles_rb + 1) * tile_bytes
    return (f"one {block}x{block} {np.dtype(dtype).name} tile is "
            f"{tile_bytes} bytes and the widest row-block holds "
            f"{max_tiles_rb} tiles, so the floor is "
            f"(max_tiles_per_row_block + 1) * tile_bytes = {need} bytes; "
            "size the budget at >= 2x the expected frontier working set")


class HostTilePool:
    """Host tier: the full padded tile pool + slot tables (numpy).

    ``mat`` is a numpy-backed ``ops.BlockSparse`` on the same growth ladder
    as the device layout; :meth:`apply_delta` patches it in O(batch)
    through ``ops.plan_delta`` and returns the plan, so callers can
    invalidate exactly the touched row-blocks."""

    def __init__(self, mat: ops.BlockSparse):
        if not isinstance(mat.tiles, np.ndarray):
            raise TypeError(
                "HostTilePool wraps the numpy layout — build the matrix "
                "with build_block_sparse(..., to_device=False)")
        self.mat = mat

    @classmethod
    def from_edges(cls, rows: np.ndarray, cols: np.ndarray, n_rows: int,
                   n_cols: int, *, block: int, dtype=np.float32
                   ) -> "HostTilePool":
        return cls(ops.build_block_sparse(
            rows, cols, n_rows, n_cols, block=block, dtype=dtype,
            padded=True, to_device=False))

    @property
    def n_rb(self) -> int:
        return self.mat.n_rb

    @property
    def block(self) -> int:
        return self.mat.block

    @property
    def tile_cols(self) -> np.ndarray:
        return self.mat.tile_cols

    @property
    def tile_idx2d(self) -> np.ndarray:
        return self.mat.tile_idx.reshape(self.mat.tile_cols.shape)

    @property
    def nbytes(self) -> int:
        return int(self.mat.tiles.nbytes + self.mat.tile_cols.nbytes
                   + self.mat.tile_idx.nbytes)

    def row_sums(self) -> np.ndarray:
        """Per-row-block sum of the live tile entries: the host-truth side
        of the integrity check's ``tile_sums`` on a tiered session."""
        tc = self.mat.tile_cols
        occ_rb, occ_slot = np.nonzero(tc >= 0)
        tid = self.tile_idx2d[occ_rb, occ_slot]
        per_tile = self.mat.tiles.reshape(self.mat.tiles.shape[0], -1).sum(1)
        out = np.zeros(self.n_rb, per_tile.dtype)
        np.add.at(out, occ_rb, per_tile[tid])
        return out

    def apply_delta(self, rows: np.ndarray, cols: np.ndarray,
                    values: np.ndarray) -> ops.DeltaPlan:
        """Host-tier sibling of ``ops.apply_delta``: the same plan and the
        same ladder growth, one ``np.add.at`` for the scatter."""
        mat = self.mat
        B, n_cb = mat.block, mat.n_cb
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(values, dtype=mat.tiles.dtype)
        if len(rows) == 0:
            return ops.DeltaPlan(tid=rows, n_old=0, n_new=0, tile_cols=None,
                                 tile_idx=None, max_tiles=mat.max_tiles,
                                 touched_rb=np.zeros(0, np.int32))
        if (rows.min() < 0 or cols.min() < 0 or rows.max() >= mat.n_rows
                or cols.max() >= mat.n_cols):
            raise ValueError(
                f"delta coordinates outside the fixed {mat.n_rows}x"
                f"{mat.n_cols} host-tier block grid; rebuild the pool")
        plan = ops.plan_delta(mat.tile_cols, self.tile_idx2d, rows, cols,
                              n_cb=n_cb, block=B, max_tiles=mat.max_tiles)
        tiles = mat.tiles
        if plan.n_live > tiles.shape[0]:
            cap = ops.capacity_bucket(plan.n_live)
            tiles = np.concatenate(
                [tiles, np.zeros((cap - tiles.shape[0], B, B), tiles.dtype)])
        # flat offsets stay int64: capacity * B^2 can exceed 2^31
        flat = (plan.tid.astype(np.int64) * (B * B)
                + (rows % B) * B + (cols % B))
        np.add.at(tiles.reshape(-1), flat, vals)
        tile_cols, tile_idx = mat.tile_cols, mat.tile_idx
        max_tiles = mat.max_tiles
        if plan.tile_cols is not None:
            tile_cols = plan.tile_cols
            tile_idx = plan.tile_idx.reshape(-1)
            max_tiles = plan.max_tiles
        self.mat = ops.host_block_sparse(mat.n_rows, mat.n_cols, B,
                                         max_tiles, tiles, tile_cols,
                                         tile_idx)
        return plan

    def copy(self) -> "HostTilePool":
        m = self.mat
        return HostTilePool(ops.host_block_sparse(
            m.n_rows, m.n_cols, m.block, m.max_tiles, m.tiles.copy(),
            m.tile_cols.copy(), m.tile_idx.copy()))


def _pack_host(T: np.ndarray):
    """The nonzeros of dense tiles ``T [k, B, B]`` in row-major order, as
    ``ops._pack_tiles`` packs them: (in-tile row u8, col u8, value, count
    per tile)."""
    k, B, _ = T.shape
    p = np.flatnonzero(T != 0)      # a bool scan: ~3x a float one
    t = p // (B * B)
    q = p - t * (B * B)
    return ((q // B).astype(np.uint8), (q % B).astype(np.uint8),
            T.reshape(-1)[p], np.bincount(t, minlength=k))


def _entry_crc(row: np.ndarray, col: np.ndarray, val: np.ndarray) -> int:
    return zlib.crc32(row.tobytes() + col.tobytes()
                      + np.ascontiguousarray(val).tobytes())


class HotSetManager:
    """Fixed-budget device slab of hot row-blocks over a host tile pool.

    Residency is per **row-block** (a block is resident iff every occupied
    tile of its slot row is in the slab), the granularity at which the
    fused driver compacts its frontier.  Slab slot 0 is a permanent empty
    tile that every non-resident slot maps to, so the device view is always
    a well-formed ``ops.BlockSparse`` and the SpMV kernels need no tiering
    awareness at all."""

    def __init__(self, pool: HostTilePool, device_budget_bytes: int, *,
                 device="cuda"):
        B = pool.block
        dtype = pool.mat.tiles.dtype
        self.pool = pool
        self.budget_bytes = int(device_budget_bytes)
        self.tile_bytes = B * B * np.dtype(dtype).itemsize
        cap = slab_tiles_for_budget(device_budget_bytes, B, dtype)
        max_rb = int((pool.tile_cols >= 0).sum(axis=1).max(initial=1))
        if cap < max_rb + 1:
            raise ValueError(
                f"device_budget_bytes={device_budget_bytes} holds only "
                f"{cap} tile(s) — too small to make a single row-block "
                f"resident: {budget_hint(B, dtype, max_tiles_rb=max_rb)}")
        self.slab_cap = cap
        self.device = dev = resolve_device(device)
        n_rb = pool.n_rb
        # host bookkeeping
        self.resident = np.zeros(n_rb, bool)
        self.last_touch = np.zeros(n_rb, np.int64)
        self._last_admit = np.zeros(n_rb, np.int64)
        self._ref = np.zeros(n_rb, bool)          # second-chance bit
        self._step = 0
        self._slot_of_tile = np.zeros(pool.mat.tiles.shape[0], np.int32)
        self._free: List[int] = list(range(cap - 1, 0, -1))  # slot 0 reserved
        self._rb_slots: Dict[int, List[int]] = {}
        self._tables_dirty = True
        # device state: the packed slab keyed by slab slot (bound_h holds
        # each slot's exact entry count, _off_h its first entry)
        tdt = as_torch_dtype(dtype)
        self._index = ops.PackedIndex(
            off=torch.zeros(cap, dtype=torch.int32, device=dev),
            cnt=torch.zeros(cap, dtype=torch.int32, device=dev),
            row=torch.zeros(0, dtype=torch.uint8, device=dev),
            col=torch.zeros(0, dtype=torch.uint8, device=dev),
            val=torch.zeros(0, dtype=tdt, device=dev),
            tail=0, bound_h=np.zeros(cap, np.int64))
        self._off_h = np.zeros(cap, np.int64)
        self._no_tiles = torch.zeros((0, B, B), dtype=tdt, device=dev)
        self._tile_cols_h = pool.tile_cols
        self._dev_idx_h = np.zeros(n_rb * pool.mat.max_tiles, np.int32)
        self._dev_tile_cols = ops._upload(self._tile_cols_h, dev)
        self._dev_tile_idx = ops._upload(self._dev_idx_h, dev)
        self._rb_res = torch.zeros(n_rb, dtype=torch.bool, device=dev)
        self.counters = {"hits": 0, "misses": 0, "evictions": 0,
                         "admitted_tiles": 0, "transfer_bytes": 0,
                         "refill_drives": 0, "refill_stalls": 0}
        # port-only: compactions of the packed slab and the entries moved
        self.index_counters = {"index_repacks": 0, "repacked_entries": 0}

    # -- device view ---------------------------------------------------------
    def view(self) -> ops.BlockSparse:
        """The slab as an ordinary ``BlockSparse`` (what the fused driver
        and the SpMV kernels read): the slot tables map resident tiles to
        slab slots, ``index`` is the packed slab, ``tiles`` is empty."""
        m = self.pool.mat
        return ops.BlockSparse(
            n_rows=m.n_rows, n_cols=m.n_cols, block=m.block,
            max_tiles=int(self._dev_tile_cols.shape[1]),
            tiles=self._no_tiles, tile_cols=self._dev_tile_cols,
            tile_idx=self._dev_tile_idx, tile_cols_h=self._tile_cols_h,
            tile_idx_h=self._dev_idx_h, index=self._index)

    @property
    def rb_res(self) -> torch.Tensor:
        return self._rb_res

    # -- invalidation --------------------------------------------------------
    def invalidate(self, touched_rb: np.ndarray, *,
                   structure_changed: bool = False) -> None:
        """Drop residency of delta-touched row-blocks (their slab entries
        are stale); the next :meth:`admit` re-packs them from host truth.
        ``structure_changed`` also marks the slot tables dirty (the pool
        rewidened or appended tiles)."""
        rbs = np.asarray(touched_rb, np.int64).reshape(-1)
        # grow the tile→slot map first: _drop reads post-growth tile ids
        cap = self.pool.mat.tiles.shape[0]
        if cap > len(self._slot_of_tile):
            grown = np.zeros(cap, np.int32)
            grown[:len(self._slot_of_tile)] = self._slot_of_tile
            self._slot_of_tile = grown
            self._tables_dirty = True
        for rb in rbs.tolist():
            self._drop(int(rb))
        if len(rbs) or structure_changed:
            self._tables_dirty = True

    def invalidate_all(self) -> None:
        self.invalidate(np.nonzero(self.resident)[0],
                        structure_changed=True)

    def _drop(self, rb: int) -> None:
        if not self.resident[rb]:
            return
        slots = self._rb_slots.pop(rb, [])
        self._free.extend(slots)
        self._index.bound_h[slots] = 0      # their entries are garbage now
        self.resident[rb] = False
        self._ref[rb] = False
        # tiles of rb fall back to the empty slot
        tc = self.pool.tile_cols[rb]
        tid = self.pool.tile_idx2d[rb][tc >= 0]
        self._slot_of_tile[tid] = 0

    # -- eviction (clock / second-chance over last_touch) --------------------
    def _eviction_order(self, protected: np.ndarray) -> List[int]:
        """Resident, unprotected blocks, oldest touch first."""
        cand = np.nonzero(self.resident & ~protected)[0]
        return cand[np.argsort(self.last_touch[cand], kind="stable")].tolist()

    def _evict_until(self, need: int, order: List[int]) -> None:
        """Free slab slots until ``need`` fit, walking ``order`` (from
        :meth:`_eviction_order`) oldest-touch-first; a block whose
        reference bit is set since the hand last passed is skipped once
        (second chance).  The reference recomputes the order before each
        eviction; within one admission only evictions change it, so the
        caller's list, with each evicted block removed, is the same order."""
        while len(self._free) < need:
            if not order:
                return                      # nothing evictable; caller defers
            for i, rb in enumerate(order):
                if self._ref[rb]:
                    self._ref[rb] = False   # second chance
                    continue
                del order[i]
                self._drop(rb)
                self.counters["evictions"] += 1
                break
            else:
                # every candidate spent its second chance this pass; the
                # next pass evicts the oldest unconditionally
                self._ref[order] = False

    # -- admission -----------------------------------------------------------
    def admit(self, want_rb: np.ndarray) -> int:
        """Make the requested row-blocks device-resident (as many as fit):
        their tiles packed on the host and uploaded in one batch, then one
        slot-table upload.  Returns the number admitted.  Blocks that do
        not fit stay non-resident — the driver defers them and the
        session's refill loop retries after this admission."""
        self._step += 1
        want = np.unique(np.asarray(want_rb, np.int64).reshape(-1))
        want = want[(want >= 0) & (want < self.pool.n_rb)]
        if len(want) == 0:
            if self._tables_dirty:
                self._upload_tables()
            return 0
        hit = self.resident[want]
        self.counters["hits"] += int(hit.sum())
        self.counters["misses"] += int((~hit).sum())
        self.last_touch[want] = self._step
        self._ref[want] = True
        missing = want[~hit]
        # fairness: least-recently-admitted first, else a want set larger
        # than the slab starves its tail on every refill round
        missing = missing[np.argsort(self._last_admit[missing],
                                     kind="stable")]
        protected = np.zeros(self.pool.n_rb, bool)
        protected[want] = True
        admitted = 0
        tids: List[np.ndarray] = []
        slots: List[int] = []
        order: Optional[List[int]] = None
        tc = self.pool.tile_cols
        ti = self.pool.tile_idx2d
        for rb in missing.tolist():
            rb_tid = ti[rb][tc[rb] >= 0]
            need = len(rb_tid)
            if need > len(self._free):
                if order is None:
                    order = self._eviction_order(protected)
                self._evict_until(need, order)
            if need > len(self._free):
                continue                    # defer: retried next refill
            rb_slots = [self._free.pop() for _ in range(need)]
            self._rb_slots[rb] = rb_slots
            self._slot_of_tile[rb_tid] = np.asarray(rb_slots, np.int32)
            self.resident[rb] = True
            self._last_admit[rb] = self._step
            tids.append(rb_tid)
            slots.extend(rb_slots)
            admitted += 1
        if tids:
            self._land(np.concatenate(tids), np.asarray(slots, np.int64))
            k = len(slots)
            self.counters["admitted_tiles"] += k
            self.counters["transfer_bytes"] += k * self.tile_bytes
            self._tables_dirty = True
        if self._tables_dirty:
            self._upload_tables()
        return admitted

    def _land(self, tid: np.ndarray, slots: np.ndarray) -> None:
        """Pack pool tiles ``tid`` on the host and write their entries at
        the slab's tail, owned by slab slots ``slots``."""
        B = self.pool.block
        tiles = self.pool.mat.tiles
        step = max(1, PACK_CHUNK_ELEMS // (B * B))
        parts = [_pack_host(tiles[tid[a:a + step]])
                 for a in range(0, len(tid), step)]
        cnt = np.concatenate([p[3] for p in parts])
        total = int(cnt.sum())
        self._reserve(total)
        idx, dev = self._index, self.device
        start = idx.tail
        off = np.zeros(len(cnt), np.int64)
        np.cumsum(cnt[:-1], out=off[1:])
        off += start
        if total:
            span = slice(start, start + total)
            for k, dst in enumerate((idx.row, idx.col, idx.val)):
                dst[span] = ops._upload(np.concatenate([p[k] for p in parts]),
                                        dev)
        sl = ops._upload(slots, dev)
        idx.off[sl] = ops._upload(off.astype(np.int32), dev)
        idx.cnt[sl] = ops._upload(cnt.astype(np.int32), dev)
        self._off_h[slots] = off
        idx.bound_h[slots] = cnt
        idx.tail = start + total

    def _reserve(self, need: int) -> None:
        """Room for ``need`` more entries at the tail: when it runs out, the
        resident entries are compacted to the front on the device, into a
        larger entry pool if they and ``need`` do not fit the current one
        (a quarter spare, on ``ops.capacity_bucket``)."""
        idx = self._index
        if idx.tail + need <= idx.entry_capacity:
            return
        live_slots = np.asarray(
            [s for v in self._rb_slots.values() for s in v], np.int64)
        cnt = idx.bound_h[live_slots]
        live = int(cnt.sum())
        cap = idx.entry_capacity
        if live + need > cap:
            want = live + need
            cap = ops.capacity_bucket(
                want + max(want // 4, self.pool.block ** 2))
            ops.check_i32(cap, "packed slab entry")
        new_off = np.zeros(len(cnt), np.int64)
        np.cumsum(cnt[:-1], out=new_off[1:])
        dev = self.device
        row = torch.zeros(cap, dtype=torch.uint8, device=dev)
        col = torch.zeros(cap, dtype=torch.uint8, device=dev)
        val = torch.zeros(cap, dtype=idx.val.dtype, device=dev)
        if live:
            src = ops._upload(np.repeat(self._off_h[live_slots] - new_off,
                                        cnt) + np.arange(live), dev)
            row[:live] = idx.row[src]
            col[:live] = idx.col[src]
            val[:live] = idx.val[src]
            idx.off[ops._upload(live_slots, dev)] = ops._upload(
                new_off.astype(np.int32), dev)
        idx.row, idx.col, idx.val = row, col, val
        self._off_h[live_slots] = new_off
        idx.tail = live
        self.index_counters["index_repacks"] += 1
        self.index_counters["repacked_entries"] += live

    def _upload_tables(self) -> None:
        """Re-derive and upload the device slot tables and residency from
        the host bookkeeping (index-sized; counted in transfer_bytes)."""
        pool = self.pool
        dev_idx = self._slot_of_tile[pool.tile_idx2d.reshape(-1)]
        self._tile_cols_h, self._dev_idx_h = pool.tile_cols, dev_idx
        self._dev_tile_cols = ops._upload(pool.tile_cols, self.device)
        self._dev_tile_idx = ops._upload(dev_idx, self.device)
        self._rb_res = ops._upload(self.resident.copy(), self.device)
        self.counters["transfer_bytes"] += (
            pool.tile_cols.nbytes + dev_idx.nbytes + self.resident.nbytes)
        self._tables_dirty = False

    # -- introspection -------------------------------------------------------
    def device_bytes(self) -> int:
        """Bytes the slab really holds on the device: the packed entries,
        their per-slot offsets and counts, the slot tables and ``rb_res``."""
        return int(self._index.nbytes + self._no_tiles.nbytes
                   + self._dev_tile_cols.nbytes + self._dev_tile_idx.nbytes
                   + self._rb_res.nbytes)

    def stats(self) -> dict:
        """The reference's counters (``slab_bytes`` and ``transfer_bytes``
        in its dense-tile units), then the port's: the real
        ``device_bytes`` and the slab compactions."""
        c = self.counters
        lookups = c["hits"] + c["misses"]
        return {
            "slab_tiles": int(self.slab_cap),
            "slab_bytes": int(self.slab_cap * self.tile_bytes),
            "budget_bytes": int(self.budget_bytes),
            "pool_tiles": int(self.pool.mat.tiles.shape[0]),
            "pool_bytes": int(self.pool.nbytes),
            "resident_blocks": int(self.resident.sum()),
            "hit_rate": (c["hits"] / lookups) if lookups else 1.0,
            **{k: int(v) for k, v in c.items()},
            "device_bytes": self.device_bytes(),
            **{k: int(v) for k, v in self.index_counters.items()},
        }

    def scrub(self) -> List[dict]:
        """CRC each resident tile's packed slab entries against the same
        tile of the host pool, packed the same way.  Returns failure dicts
        in the reference's ``_integrity_check`` shape (``hot_slab``, the
        check that sends a tiered session to the ``rebuild`` rung); empty
        list = clean."""
        idx = self._index
        off, cnt, row, col, val = (t.cpu().numpy() for t in (
            idx.off, idx.cnt, idx.row, idx.col, idx.val))
        bad: List[int] = []
        for rb, slots in self._rb_slots.items():
            tc = self.pool.tile_cols[rb]
            tid = self.pool.tile_idx2d[rb][tc >= 0]
            for t, s in zip(tid.tolist(), slots):
                r, c, v, _ = _pack_host(self.pool.mat.tiles[t:t + 1])
                e = slice(int(off[s]), int(off[s]) + int(cnt[s]))
                if _entry_crc(r, c, v) != _entry_crc(row[e], col[e], val[e]):
                    bad.append(rb)
                    break
        if bad:
            return [{"check": "hot_slab", "row_blocks": sorted(bad)[:8]}]
        return []

    def fork(self, pool: HostTilePool) -> "HotSetManager":
        """Twin over a copied pool: copies every mutable host table, the
        counters and the packed slab (admission writes it in place, where
        the reference's slab is immutable and shared)."""
        new = object.__new__(HotSetManager)
        new.__dict__.update(self.__dict__)
        new.pool = pool
        new.resident = self.resident.copy()
        new.last_touch = self.last_touch.copy()
        new._last_admit = self._last_admit.copy()
        new._ref = self._ref.copy()
        new._slot_of_tile = self._slot_of_tile.copy()
        new._free = list(self._free)
        new._rb_slots = {k: list(v) for k, v in self._rb_slots.items()}
        new._index = self._index.clone()
        new._off_h = self._off_h.copy()
        new.counters = dict(self.counters)
        new.index_counters = dict(self.index_counters)
        return new


def host_block_adjacency(tile_cols: np.ndarray, n_cb: int) -> np.ndarray:
    """Numpy twin of ``ops.block_adjacency`` for the host tier (the
    stream keeps ``MatrixAux`` on the host; a tiered open never puts the
    full slot table on the device just to OR it)."""
    n_rb = tile_cols.shape[0]
    out = np.zeros((n_rb, n_cb), bool)
    rb, slot = np.nonzero(tile_cols >= 0)
    out[rb, tile_cols[rb, slot]] = True
    return out


# ---------------------------------------------------------------------------
# EdgePager — the blocked engine's analogue over per-block edge extents
# ---------------------------------------------------------------------------

#: the 8-tuple ``ensure`` returns, in sweep-operand order:
#: (src, dst, osrc, odst, in_lo, in_len, out_lo, out_len)
EdgeView = Tuple

#: the reference's slab arrays carry a ``dynamic_slice`` tail guard of this
#: many entries; the port's sweep reads no entry past a slice's end and
#: allocates none, but ``transfer_bytes`` counts it, so the counters of the
#: two packages stay equal
REFERENCE_SLAB_GUARD = 1024


@dataclasses.dataclass
class _HostEdges:
    """Host copies of a snapshot's per-block edge extents."""
    src: np.ndarray
    dst: np.ndarray
    in_ptr: np.ndarray
    osrc: np.ndarray
    odst: np.ndarray
    out_ptr: np.ndarray


class EdgePager:
    """Host-paged per-block edge extents for ``run_blocked(pager=)``.

    A sweep reads each active block's in-edge slice (the pull) and
    out-edge slice (the expansion).  The pager keeps both on the host and
    stages the active set's slices into four fixed device slabs before each
    sweep; per-block ``lo``/``len`` tables (index-sized) redirect the sweep
    into them.  A block's in- and out-slice share one offset of a bump
    allocator, which advances by the longer of the two.  A sweep whose
    active set does not fit *repacks*: blocks outside the requested set
    are dropped (counted as evictions) and the slab is rebuilt from the
    want set; a want set that cannot fit at all raises with the sizing
    rule.  The slabs are uploaded only after a staging changed them.  The
    blocked engine already reads the active ids on the host every sweep,
    so staging adds no host sync."""

    def __init__(self, g, budget_bytes: int):
        self.h = _HostEdges(
            src=g.src.cpu().numpy(), dst=g.dst.cpu().numpy(),
            in_ptr=g.in_block_ptr.cpu().numpy().astype(np.int64),
            osrc=g.osrc.cpu().numpy(), odst=g.odst.cpu().numpy(),
            out_ptr=g.out_block_ptr.cpu().numpy().astype(np.int64))
        self.device = g.device
        self.n_blocks = len(self.h.in_ptr) - 1
        # 4 slab arrays (in src/dst + out src/dst) of int32
        cap = int(budget_bytes) // (4 * 4)
        sizes = (np.diff(self.h.in_ptr) + np.diff(self.h.out_ptr))
        if cap < int(sizes.max(initial=1)) + 1:
            raise ValueError(
                f"edge budget {budget_bytes} bytes holds {cap} edges per "
                f"slab but the largest block needs {int(sizes.max())} — "
                "raise the budget above max_block_edges * 16 bytes")
        self.cap = cap
        self._hsrc = np.zeros(cap, np.int32)
        self._hdst = np.zeros(cap, np.int32)
        self._hosrc = np.zeros(cap, np.int32)
        self._hodst = np.zeros(cap, np.int32)
        self._in_lo = np.zeros(self.n_blocks, np.int32)
        self._in_len = np.zeros(self.n_blocks, np.int32)
        self._out_lo = np.zeros(self.n_blocks, np.int32)
        self._out_len = np.zeros(self.n_blocks, np.int32)
        self._resident = np.zeros(self.n_blocks, bool)
        self._cursor = 0                   # bump allocator over the slab
        self._dirty = True
        self._dev: Optional[EdgeView] = None
        self.counters = {"hits": 0, "misses": 0, "evictions": 0,
                         "repacks": 0, "transfer_bytes": 0}

    def _stage(self, b: int) -> bool:
        h = self.h
        ilo, ihi = int(h.in_ptr[b]), int(h.in_ptr[b + 1])
        olo, ohi = int(h.out_ptr[b]), int(h.out_ptr[b + 1])
        need = max(ihi - ilo, ohi - olo)
        if self._cursor + need > self.cap:
            return False
        at = self._cursor
        self._hsrc[at:at + ihi - ilo] = h.src[ilo:ihi]
        self._hdst[at:at + ihi - ilo] = h.dst[ilo:ihi]
        self._hosrc[at:at + ohi - olo] = h.osrc[olo:ohi]
        self._hodst[at:at + ohi - olo] = h.odst[olo:ohi]
        self._in_lo[b], self._in_len[b] = at, ihi - ilo
        self._out_lo[b], self._out_len[b] = at, ohi - olo
        self._cursor = at + need
        self._resident[b] = True
        self._dirty = True
        return True

    def ensure(self, block_ids: np.ndarray) -> EdgeView:
        """Stage the given blocks, repacking the slab if they do not fit;
        returns the device :data:`EdgeView` for the sweep."""
        ids = np.unique(np.asarray(block_ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.n_blocks)]
        hit = self._resident[ids]
        self.counters["hits"] += int(hit.sum())
        self.counters["misses"] += int((~hit).sum())
        missing = ids[~hit].tolist()
        for b in list(missing):
            if self._stage(int(b)):
                missing.remove(b)
        if missing:
            # repack: keep only the want set, then stage the rest
            self.counters["repacks"] += 1
            self.counters["evictions"] += int(
                (self._resident & ~np.isin(np.arange(self.n_blocks),
                                           ids)).sum())
            keep = [int(b) for b in ids if self._resident[b]]
            self._resident[:] = False
            self._cursor = 0
            for b in keep + [int(b) for b in missing]:
                if not self._stage(b):
                    raise ValueError(
                        "active set does not fit the edge slab even after "
                        "a repack — raise the pager budget")
        if self._dirty:
            # on the card an asynchronous copy (no host sync); on the CPU a
            # copy, so a later staging never writes a view already handed out
            cpu = self.device.type == "cpu"
            self._dev = tuple(
                torch.from_numpy(a.copy()) if cpu
                else ops._upload(a, self.device) for a in (
                    self._hsrc, self._hdst, self._hosrc, self._hodst,
                    self._in_lo, self._in_len, self._out_lo, self._out_len))
            self.counters["transfer_bytes"] += 4 * 4 * (
                self.cap + REFERENCE_SLAB_GUARD)
            self._dirty = False
        return self._dev

    def stats(self) -> dict:
        c = self.counters
        lookups = c["hits"] + c["misses"]
        return {"slab_edges": int(self.cap),
                "hit_rate": (c["hits"] / lookups) if lookups else 1.0,
                **{k: int(v) for k, v in c.items()}}


def paged_snapshot(g):
    """A twin of ``g`` whose O(m) edge arrays are one-element stubs — pass
    it to ``run_blocked(..., pager=EdgePager(g, budget))`` so the device
    never holds the full CSR: the pager's bounded slab is then the only
    O(edges) device allocation.  The per-block pointer tables, the
    per-vertex in-edge offsets ``in_ptr`` (which a sweep rebases into the
    slab) and the per-vertex arrays are kept.  Build the
    :class:`EdgePager` from the original snapshot: it copies the edge
    arrays to the host."""
    vptr = g.in_ptr                        # cached on g before the stubs
    z = torch.zeros(1, dtype=torch.int32, device=g.device)
    new = dataclasses.replace(g, src=z, dst=z, osrc=z, odst=z)
    new.__dict__["in_ptr"] = vptr          # the cached_property's slot
    return new
