"""Block-sparse tile layout, its incremental builder, and the SpMV front end.

Ports ``src/repro/kernels/block_spmv/ops.py``: the capacity-padded
``BlockSparse`` tile pool with its slot tables, the host-side delta
bookkeeping (``plan_delta``, copied), the device scatter of a delta batch
(``apply_delta``), and the SpMV entry points that launch the tile kernels of
:mod:`repro_torch.kernels.block_spmv.block_spmv`.

Differences from the JAX module, each because the device differs:

* ``BlockSparse`` is a dataclass of torch tensors that also carries the host
  numpy twins of its slot tables, so ``plan_delta`` never copies them back
  from the device.
* ``BlockSparse`` also carries a :class:`PackedIndex` of each tile's
  nonzeros, the operand of the CUDA kernels (which never read the dense
  tiles).  It is built from the tiles once (:func:`build_index`) and kept in
  step by ``apply_delta``, which re-packs only the tiles a batch lands in
  (:func:`refresh_index`).
* ``apply_delta`` patches the tile pool and the index **in place** (one
  ``index_add_``, then the re-pack) — the JAX version returns a new pool.
  A caller that still needs the pre-delta tiles or index computes with them
  before calling it.  Tile values are sums of ±1, so the unordered CUDA
  scatter is exact.
* ``block_spmv_active_bucketed`` keeps its signature but makes ONE
  persistent launch over the full ``[n_rb]`` id list that stops at the
  device count ``n_active``, which is never read back to size a launch.
  The static ``lax.switch`` ladder of the TPU has no purpose here.
* There is no ``backend=`` knob: the tensors' device picks the kernel (CUDA)
  or its plain version (CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.kernels.block_spmv import block_spmv as bsk

TILE_CAP_BASE = 8        # minimum tile-pool capacity bucket
SLOT_CAP_BASE = 4        # minimum per-row slot-table width bucket
ACTIVE_LADDER_BASE = 8   # smallest active-block grid bucket
INDEX_CHUNK_ELEMS = 1 << 23   # dense tile elements packed per step

I32_MAX = np.iinfo(np.int32).max


def check_i32(count: int, what: str) -> None:
    """Guard for the int32 index diet: slot tables, tile ids and block
    indices are stored 32-bit; past 2^31 entries the narrow layout would
    silently alias, so fail loudly at the boundary instead."""
    if count > I32_MAX:
        raise OverflowError(
            f"{what} count {count} exceeds the int32 index range "
            f"({I32_MAX}); the 32-bit slot-table/index layout cannot "
            "address it — raise block_size so per-structure counts stay "
            "below 2^31")


def capacity_bucket(n: int, base: int = TILE_CAP_BASE) -> int:
    """Smallest power-of-two multiple of ``base`` ≥ n (doubling ladder)."""
    cap = base
    while cap < n:
        cap *= 2
    return cap


def active_ladder(n_rb: int, base: int = ACTIVE_LADDER_BASE
                  ) -> Tuple[int, ...]:
    """The doubling ladder (base, 2·base, …, n_rb) of the JAX package's
    bucketed dispatch.  The port launches once over the full list; the
    ladder is kept for callers that size buffers by it."""
    out = []
    K = base
    while K < n_rb:
        out.append(K)
        K *= 2
    out.append(n_rb)
    return tuple(out)


def _upload(a, dev: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on ``dev`` without a host sync: on the
    card through a pinned staging copy and an asynchronous transfer on the
    current stream; on the CPU the tensor itself (sharing ``a``'s memory)."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


@dataclasses.dataclass
class PackedIndex:
    """The nonzeros of every tile of a pool, packed — the operand of the CUDA
    tile-SpMV kernels, which never read the dense tiles.

    Keyed by tile id, so slot-table rebuilds never invalidate it.  Tile t's
    nonzeros are entries ``off[t] : off[t] + cnt[t]`` of ``row``/``col``
    (their place within the tile) and ``val``, in row-major order (rows
    ascending, columns ascending within a row).  Entries past ``tail`` are
    free; space a re-pack abandoned is reclaimed when the tail runs out
    (:func:`refresh_index` then rebuilds).  ``bound_h`` is a host upper
    bound of each ``cnt`` that sizes a re-pack's space without reading the
    device."""
    off: torch.Tensor          # [tile_capacity] int32
    cnt: torch.Tensor          # [tile_capacity] int32
    row: torch.Tensor          # [entry_capacity] uint8
    col: torch.Tensor          # [entry_capacity] uint8
    val: torch.Tensor          # [entry_capacity] tile dtype
    tail: int                  # first free entry
    bound_h: np.ndarray        # [tile_capacity] int64, ≥ cnt

    @property
    def entry_capacity(self) -> int:
        return int(self.val.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in (self.off, self.cnt, self.row, self.col,
                                      self.val))

    def clone(self) -> "PackedIndex":
        """A copy sharing no storage (``refresh_index`` writes in place)."""
        return PackedIndex(
            off=self.off.clone(), cnt=self.cnt.clone(), row=self.row.clone(),
            col=self.col.clone(), val=self.val.clone(), tail=self.tail,
            bound_h=self.bound_h.copy())


def _pack_tiles(index: PackedIndex, T: torch.Tensor, ids: torch.Tensor,
                res: np.ndarray, start: int) -> None:
    """Pack the dense tiles ``T [k, B, B]`` (tile ids ``ids`` [k] on T's
    device) into ``index``: tile i gets ``res[i]`` entries (host ints, each
    ≥ its nonzero count) from ``start`` on, in order, and the entry range
    ``[start, start + sum(res))`` is written whole (slack as zeros).  The
    q-th nonzero of a tile is found by a binary search of the running count
    of nonzeros, so no output size is read back: device work only."""
    k, B, _ = T.shape
    dev = T.device
    nz = T != 0
    cnt = nz.sum((1, 2), dtype=torch.int32)
    first = np.zeros(k, np.int64)
    np.cumsum(res[:-1], out=first[1:])
    off = _upload(start + first, dev)
    index.off[ids] = off.to(torch.int32)
    index.cnt[ids] = cnt
    total = int(res.sum())
    if total == 0:
        return
    owner = torch.repeat_interleave(torch.arange(k, device=dev),
                                    _upload(res, dev), output_size=total)
    q = torch.arange(total, device=dev) - (off - start)[owner]
    run = nz.reshape(-1).cumsum(0)                  # nonzeros up to here
    before = (cnt.cumsum(0) - cnt).long()           # nonzeros of tiles < i
    live = q < cnt[owner]
    p = torch.where(live, torch.searchsorted(run, before[owner] + q + 1), 0)
    span = slice(start, start + total)
    index.row[span] = torch.where(live, p // B % B, 0).to(torch.uint8)
    index.col[span] = torch.where(live, p % B, 0).to(torch.uint8)
    index.val[span] = torch.where(live, T.reshape(-1)[p], 0)


def build_index(tiles: torch.Tensor) -> PackedIndex:
    """The packed index of a whole tile pool, on the pool's device, packed
    in steps of :data:`INDEX_CHUNK_ELEMS` dense elements.  One host sync:
    the per-tile counts, which size the entry pool (the live entries plus
    a quarter, at least one tile's worth, on :func:`capacity_bucket`)."""
    if not isinstance(tiles, torch.Tensor):
        raise TypeError(
            "build_index packs a device tile pool; the host-tier layout "
            "(build_block_sparse(to_device=False)) has no packed index")
    cap, B, _ = tiles.shape
    dev = tiles.device
    step = max(1, INDEX_CHUNK_ELEMS // (B * B))
    cnt = torch.empty(cap, dtype=torch.int64, device=dev)
    for a in range(0, cap, step):
        cnt[a:a + step] = (tiles[a:a + step] != 0).sum((1, 2))
    cnt_h = cnt.cpu().numpy()
    nnz = int(cnt_h.sum())
    e_cap = capacity_bucket(nnz + max(nnz // 4, B * B))
    check_i32(e_cap, "packed entry")
    index = PackedIndex(
        off=torch.zeros(cap, dtype=torch.int32, device=dev),
        cnt=torch.zeros(cap, dtype=torch.int32, device=dev),
        row=torch.zeros(e_cap, dtype=torch.uint8, device=dev),
        col=torch.zeros(e_cap, dtype=torch.uint8, device=dev),
        val=torch.zeros(e_cap, dtype=tiles.dtype, device=dev),
        tail=nnz, bound_h=cnt_h.astype(np.int64))
    start = 0
    for a in range(0, cap, step):
        res = index.bound_h[a:a + step]
        _pack_tiles(index, tiles[a:a + step],
                    torch.arange(a, a + len(res), device=dev), res, start)
        start += int(res.sum())
    return index


def refresh_index(index: PackedIndex, tiles: torch.Tensor, tid: np.ndarray,
                  rloc: np.ndarray, cloc: np.ndarray) -> PackedIndex:
    """Re-pack the tiles a delta batch landed in (edge k in tile ``tid[k]``
    at in-tile ``(rloc[k], cloc[k])``) from the patched pool into fresh
    space at the index's tail, in place and without a host sync.

    A position can turn nonzero only where the batch lands, so a tile's new
    count is at most its old bound plus the batch's distinct coordinates in
    it; that bound (host side) sizes the space.  The per-tile arrays grow
    with the tile pool.  When the tail is out of room the index is rebuilt
    whole (:func:`build_index`: one sync, a new entry capacity)."""
    cap, B, _ = tiles.shape
    dev = tiles.device
    grow = cap - index.off.shape[0]
    if grow > 0:
        index = dataclasses.replace(
            index, off=torch.cat([index.off, index.off.new_zeros(grow)]),
            cnt=torch.cat([index.cnt, index.cnt.new_zeros(grow)]),
            bound_h=np.concatenate([index.bound_h,
                                    np.zeros(grow, np.int64)]))
    tid = np.asarray(tid, np.int64)
    key = np.unique((tid * B + np.asarray(rloc, np.int64)) * B
                    + np.asarray(cloc, np.int64))
    touched, fresh = np.unique(key // (B * B), return_counts=True)
    bound = np.minimum(index.bound_h[touched] + fresh, B * B)
    if index.tail + int(bound.sum()) > index.entry_capacity:
        return build_index(tiles)
    step = max(1, INDEX_CHUNK_ELEMS // (B * B))
    for a in range(0, len(touched), step):
        ids = _upload(touched[a:a + step], dev)
        res = bound[a:a + step]
        _pack_tiles(index, tiles[ids], ids, res, index.tail)
        index.tail += int(res.sum())
    index.bound_h[touched] = bound
    return index


@dataclasses.dataclass
class BlockSparse:
    """Block-sparse matrix A [n_rows_pad, n_cols_pad] in B×B dense tiles.

    ``tiles[k]`` is the dense tile for the k-th stored (row-block,
    col-block) pair; ``tile_cols[i, j]`` is the column-block of the j-th tile
    of row-block i (or −1); ``tile_idx`` flat-indexes into ``tiles``.
    ``tiles.shape[0]`` is a capacity: trailing tiles no slot references are
    zero padding from the growth ladder.  ``tile_cols_h`` / ``tile_idx_h``
    are host numpy copies of the two slot tables, kept in step with the
    device ones by :func:`apply_delta`.  ``index`` packs the tiles'
    nonzeros for the CUDA kernels; one not given is built from ``tiles``.
    """
    n_rows: int
    n_cols: int
    block: int
    max_tiles: int
    tiles: torch.Tensor          # [tile_capacity, B, B]
    tile_cols: torch.Tensor      # [n_rb, max_tiles] int32
    tile_idx: torch.Tensor       # [n_rb * max_tiles] int32
    tile_cols_h: np.ndarray      # host twin of tile_cols
    tile_idx_h: np.ndarray       # host twin of tile_idx
    index: Optional[PackedIndex] = None

    def __post_init__(self):
        if isinstance(self.tiles, np.ndarray):
            # the host-tier layout (build_block_sparse(to_device=False))
            if self.index is not None:
                raise ValueError("the host-tier layout holds no packed "
                                 "index; the CUDA kernels read a device "
                                 "matrix's")
        elif self.index is None:
            self.index = build_index(self.tiles)

    @property
    def n_rb(self) -> int:
        return (self.n_rows + self.block - 1) // self.block

    @property
    def n_cb(self) -> int:
        return (self.n_cols + self.block - 1) // self.block

    @property
    def tile_capacity(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def clone(self) -> "BlockSparse":
        """A copy sharing no storage with this matrix — the tile pool, the
        slot tables (device and host) and the packed index — for a holder
        that must not see the in-place patches of :func:`apply_delta`."""
        return dataclasses.replace(
            self, tiles=self.tiles.clone(), tile_cols=self.tile_cols.clone(),
            tile_idx=self.tile_idx.clone(),
            tile_cols_h=self.tile_cols_h.copy(),
            tile_idx_h=self.tile_idx_h.copy(), index=self.index.clone())

    def n_tiles(self) -> int:
        """Live tile count (from the host slot tables; no device sync)."""
        occ = self.tile_cols_h >= 0
        if not occ.any():
            return 0
        return int(self.tile_idx_h.reshape(occ.shape)[occ].max()) + 1


def _slot_tables(tiles_rb: np.ndarray, tiles_cb: np.ndarray, n_rb: int,
                 min_max_tiles: int = 1) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-row tile lists from sorted-by-(rb, cb) tile coordinates: the slot
    of tile t within its row is ``t - row_start[rb(t)]``."""
    n_tiles = len(tiles_rb)
    check_i32(n_tiles, "tile")
    per_row = np.bincount(tiles_rb, minlength=n_rb)
    max_tiles = max(min_max_tiles, int(per_row.max(initial=1)))
    row_start = np.zeros(n_rb + 1, dtype=np.int64)
    np.cumsum(per_row, out=row_start[1:])
    slot = (np.arange(n_tiles, dtype=np.int32)
            - row_start[tiles_rb].astype(np.int32))
    tile_cols = np.full((n_rb, max_tiles), -1, dtype=np.int32)
    tile_idx = np.zeros((n_rb, max_tiles), dtype=np.int32)
    tile_cols[tiles_rb, slot] = tiles_cb
    tile_idx[tiles_rb, slot] = np.arange(n_tiles, dtype=np.int32)
    return tile_cols, tile_idx, max_tiles


def _from_tables(n_rows: int, n_cols: int, block: int, max_tiles: int,
                 tiles: torch.Tensor, tile_cols: np.ndarray,
                 tile_idx: np.ndarray,
                 index: Optional[PackedIndex] = None) -> BlockSparse:
    """A ``BlockSparse`` over ``tiles`` with these slot tables; ``index``
    carries an existing packed index over, else it is built."""
    dev = tiles.device
    tile_idx = np.array(tile_idx, dtype=np.int32).reshape(-1)
    tile_cols = np.array(tile_cols, dtype=np.int32)
    return BlockSparse(
        n_rows=n_rows, n_cols=n_cols, block=block, max_tiles=max_tiles,
        tiles=tiles, tile_cols=_upload(tile_cols, dev),
        tile_idx=_upload(tile_idx, dev),
        tile_cols_h=tile_cols, tile_idx_h=tile_idx, index=index)


def build_block_sparse(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                       n_cols: int, *, block: int = 128,
                       values: Optional[np.ndarray] = None,
                       dtype=torch.float32, padded: bool = False,
                       device="cuda", to_device: bool = True) -> BlockSparse:
    """Build tiles from an edge list: A[rows[k], cols[k]] = values[k] (or 1);
    duplicate coordinates add.

    The slot tables are derived on the host; the tile pool is allocated on
    ``device`` and filled by one scatter there, so the pool never exists in
    host memory.  ``padded=True`` preallocates the pool and the slot tables
    on the growth ladder (:func:`capacity_bucket`), the layout a dynamic
    stream uses.

    ``to_device=False`` builds the reference's numpy layout instead — the
    host tier of :mod:`repro_torch.core.tiering`: the tile pool (filled by
    one ``np.add.at``) and both slot tables are numpy arrays
    (``tile_cols_h``/``tile_idx_h`` are the same arrays), nothing is placed
    on a device and no packed index is built (``device`` is not
    consulted)."""
    dt = as_torch_dtype(dtype)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = (np.ones(rows.shape, np.float64) if values is None
            else np.asarray(values, np.float64))
    n_rb = (n_rows + block - 1) // block
    n_cb = (n_cols + block - 1) // block

    rb, cb = rows // block, cols // block
    key = rb * n_cb + cb
    order = np.argsort(key, kind="stable")
    rows, cols, vals, key = rows[order], cols[order], vals[order], key[order]
    uniq = np.unique(key)

    n_tiles = max(1, len(uniq))
    cap = capacity_bucket(n_tiles) if padded else n_tiles
    tpos = np.searchsorted(uniq, key)
    flat = tpos * (block * block) + (rows % block) * block + (cols % block)
    # values cast to the tile dtype first, as the JAX builder adds them
    if to_device:
        dev = resolve_device(device)
        tiles = torch.zeros((cap, block, block), dtype=dt, device=dev)
        if len(flat):
            tiles.view(-1).index_add_(0, torch.from_numpy(flat).to(dev),
                                      torch.from_numpy(vals).to(dt).to(dev))
    else:
        np_dt = torch.empty(0, dtype=dt).numpy().dtype
        tiles = np.zeros((cap, block, block), dtype=np_dt)
        np.add.at(tiles.reshape(-1), flat, vals.astype(np_dt))

    tiles_rb = (uniq // n_cb).astype(np.int64)
    tiles_cb = (uniq % n_cb).astype(np.int64)
    min_mt = 1
    if padded:
        per_row = np.bincount(tiles_rb, minlength=n_rb) if len(tiles_rb) \
            else np.zeros(n_rb, np.int64)
        min_mt = capacity_bucket(int(per_row.max(initial=1)), SLOT_CAP_BASE)
    tile_cols, tile_idx, max_tiles = _slot_tables(tiles_rb, tiles_cb, n_rb,
                                                  min_max_tiles=min_mt)
    if not to_device:
        return host_block_sparse(n_rows, n_cols, block, max_tiles, tiles,
                                 tile_cols, tile_idx.reshape(-1))
    return _from_tables(n_rows, n_cols, block, max_tiles, tiles, tile_cols,
                        tile_idx)


def host_block_sparse(n_rows: int, n_cols: int, block: int, max_tiles: int,
                      tiles: np.ndarray, tile_cols: np.ndarray,
                      tile_idx: np.ndarray) -> BlockSparse:
    """A host-tier ``BlockSparse`` over numpy arrays (no index, no
    device); the host twins are the tables themselves."""
    return BlockSparse(
        n_rows=n_rows, n_cols=n_cols, block=block, max_tiles=max_tiles,
        tiles=tiles, tile_cols=tile_cols, tile_idx=tile_idx,
        tile_cols_h=tile_cols, tile_idx_h=tile_idx)


@dataclasses.dataclass
class DeltaPlan:
    """Host-side bookkeeping for one delta batch against a block-sparse
    structure: where every edge lands (``tid``) plus the rebuilt slot tables
    when the batch opened new (row-block, col-block) pairs."""
    tid: np.ndarray                    # [b] target tile id per edge
    n_old: int                         # live tiles before the batch
    n_new: int                         # tiles the batch appends
    tile_cols: Optional[np.ndarray]    # rebuilt [n_rb, mt'] (None: unchanged)
    tile_idx: Optional[np.ndarray]     # rebuilt [n_rb, mt'] (None: unchanged)
    max_tiles: int                     # post-batch slot width
    touched_rb: np.ndarray             # unique row-blocks the batch lands in

    @property
    def n_live(self) -> int:
        return self.n_old + self.n_new


def plan_delta(tile_cols_h: np.ndarray, tile_idx_h: np.ndarray,
               rows: np.ndarray, cols: np.ndarray, *, n_cb: int,
               block: int, max_tiles: int) -> DeltaPlan:
    """Resolve a delta batch against host copies of the slot tables:
    per-edge target tile ids, appended-tile count, and (when new tiles
    appear) merged slot tables on the :data:`SLOT_CAP_BASE` width ladder.
    Index-sized work only — never touches tile data."""
    n_rb = tile_cols_h.shape[0]
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    key = (rows // block) * n_cb + (cols // block)

    occ = tile_cols_h >= 0
    ex_rb, ex_slot = np.nonzero(occ)
    ex_key = ex_rb * n_cb + tile_cols_h[ex_rb, ex_slot]
    ex_tid = tile_idx_h[ex_rb, ex_slot]
    order = np.argsort(ex_key)
    sk, st = ex_key[order], ex_tid[order]

    pos = np.searchsorted(sk, key)
    pos_c = np.clip(pos, 0, max(len(sk) - 1, 0))
    found = (sk[pos_c] == key) if len(sk) else np.zeros(len(key), bool)

    n_old = int(ex_tid.max()) + 1 if len(ex_tid) else 0
    new_keys = np.unique(key[~found])
    check_i32(n_old + len(new_keys), "tile")
    tid = np.where(found, st[pos_c] if len(sk) else 0,
                   n_old + np.searchsorted(new_keys, key))

    tile_cols_np = tile_idx_np = None
    out_mt = max_tiles
    if len(new_keys):
        all_key = np.concatenate([ex_key, new_keys])
        all_tid = np.concatenate([ex_tid, n_old + np.arange(len(new_keys))])
        order = np.argsort(all_key)
        all_key, all_tid = all_key[order], all_tid[order]
        t_rb = (all_key // n_cb).astype(np.int32)
        t_cb = (all_key % n_cb).astype(np.int32)
        per_row_max = int(np.bincount(t_rb, minlength=n_rb).max(initial=1))
        min_mt = max_tiles if per_row_max <= max_tiles else \
            capacity_bucket(per_row_max, SLOT_CAP_BASE)
        tile_cols_np, idx_pos, out_mt = _slot_tables(
            t_rb, t_cb, n_rb, min_max_tiles=min_mt)
        tile_idx_np = np.zeros_like(idx_pos)
        occ2 = tile_cols_np >= 0
        tile_idx_np[occ2] = all_tid[idx_pos[occ2]]

    return DeltaPlan(
        tid=tid, n_old=n_old, n_new=len(new_keys),
        tile_cols=tile_cols_np, tile_idx=tile_idx_np, max_tiles=out_mt,
        touched_rb=np.unique(rows // block).astype(np.int32))


def _scatter_delta(tiles: torch.Tensor, tid: np.ndarray, rloc: np.ndarray,
                   cloc: np.ndarray, vals: torch.Tensor, *, block: int
                   ) -> None:
    """In-place per-edge scatter-add of a delta batch into the tile pool."""
    dev = tiles.device
    flat = (tid.astype(np.int64) * (block * block)
            + rloc.astype(np.int64) * block + cloc.astype(np.int64))
    tiles.view(-1).index_add_(0, _upload(flat, dev), _upload(vals, dev))


def apply_delta(mat: BlockSparse, rows: np.ndarray, cols: np.ndarray,
                values: np.ndarray) -> BlockSparse:
    """Patch A with A[rows[k], cols[k]] += values[k], touching only the
    tiles the delta lands in.

    The tile pool is patched **in place** (one device scatter) unless the
    batch overflows its capacity bucket, in which case it grows to the next
    :func:`capacity_bucket` first (a new tensor).  New (row-block,
    col-block) pairs are appended into the preallocated capacity; the slot
    tables are rewidened only when a row's bucket overflows.  Tiles emptied
    by deletions are kept (structure grows monotonically).  The packed
    index is carried over on every path and re-packed for the touched
    tiles only (:func:`refresh_index`, no host sync).

    Raises ``ValueError`` for coordinates outside the matrix grid: the block
    grid is fixed for the lifetime of a stream.
    """
    B = mat.block
    n_rb, n_cb = mat.n_rb, mat.n_cb
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if len(rows) == 0:
        return mat
    if (rows.min() < 0 or cols.min() < 0 or rows.max() >= mat.n_rows
            or cols.max() >= mat.n_cols):
        raise ValueError(
            f"delta coordinates (rows in [{rows.min()}, {rows.max()}], cols "
            f"in [{cols.min()}, {cols.max()}]) fall outside the fixed "
            f"{mat.n_rows}x{mat.n_cols} block grid ({n_rb}x{n_cb} blocks of "
            f"{B}); a grid-size change requires a rebuild with "
            f"build_block_sparse / IncrementalPullMatrix.from_snapshot")
    plan = plan_delta(mat.tile_cols_h,
                      mat.tile_idx_h.reshape(n_rb, mat.max_tiles),
                      rows, cols, n_cb=n_cb, block=B,
                      max_tiles=mat.max_tiles)

    tiles = mat.tiles
    if plan.n_live > tiles.shape[0]:
        cap = capacity_bucket(plan.n_live)
        tiles = torch.cat([tiles, tiles.new_zeros(
            (cap - tiles.shape[0], B, B))])
    # values cast to the tile dtype first, as the JAX version does
    vals = torch.from_numpy(np.asarray(values, np.float64)).to(tiles.dtype)
    rloc, cloc = rows % B, cols % B
    _scatter_delta(tiles, plan.tid, rloc, cloc, vals, block=B)
    index = refresh_index(mat.index, tiles, plan.tid, rloc, cloc)

    if plan.tile_cols is None:
        return dataclasses.replace(mat, tiles=tiles, index=index)
    return _from_tables(mat.n_rows, mat.n_cols, B, plan.max_tiles, tiles,
                        plan.tile_cols, plan.tile_idx, index=index)


# ---------------------------------------------------------------------------
# SpMV entry points
# ---------------------------------------------------------------------------

def _pad_x(mat: BlockSparse, x: torch.Tensor) -> torch.Tensor:
    n_cb_pad = mat.n_cb * mat.block
    if x.shape[0] == n_cb_pad:
        return x.contiguous()
    xp = x.new_zeros(n_cb_pad)
    xp[:x.shape[0]] = x
    return xp


def block_spmv(mat: BlockSparse, x: torch.Tensor, *,
               semiring: str = "sum") -> torch.Tensor:
    """y = A @ x over the requested semiring; x is zero-padded to block
    size.  Kernel #1 on the card (over the packed index), its plain version
    on the CPU (over the tiles)."""
    y = bsk.tile_spmv(mat.tile_idx, mat.tile_cols, mat.tiles,
                      _pad_x(mat, x), block=mat.block,
                      max_tiles=mat.max_tiles, semiring=semiring,
                      index=mat.index)
    return y[:mat.n_rows]


def block_spmv_active(mat: BlockSparse, x: torch.Tensor,
                      active_ids: torch.Tensor, *, semiring: str = "sum",
                      n_active: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Frontier-compacted y = A @ x restricted to the row-blocks in
    ``active_ids`` (−1 entries skipped; on the card, entries from the device
    count ``n_active`` on are not computed).  Rows of inactive blocks are
    UNDEFINED — mask with the active-block indicator before consuming."""
    y = bsk.tile_spmv_active(active_ids.to(torch.int32).contiguous(),
                             mat.tile_idx, mat.tile_cols, mat.tiles,
                             _pad_x(mat, x), block=mat.block,
                             max_tiles=mat.max_tiles, semiring=semiring,
                             index=mat.index, n_active=n_active)
    return y[:mat.n_rows]


def block_spmv_active_bucketed(mat: BlockSparse, x: torch.Tensor,
                               active_ids: torch.Tensor,
                               n_active: torch.Tensor, *,
                               semiring: str = "sum") -> torch.Tensor:
    """Frontier-proportional active SpMV: ``active_ids`` is the full
    compacted slot list ([n_rb], −1-padded) and ``n_active`` its (device)
    count of real entries.  One launch over the whole list whose walk stops
    at ``n_active`` on the device, so the count is never read back."""
    return block_spmv_active(mat, x, active_ids, semiring=semiring,
                             n_active=n_active)


def block_spmv_push_bucketed(mat: BlockSparse, x: torch.Tensor,
                             src_cb: torch.Tensor, active_ids: torch.Tensor,
                             n_active: torch.Tensor) -> torch.Tensor:
    """Scatter-semiring push step on the pull tile layout.

    Forward push moves each selected source's residual along its
    *out*-edges: ``y[v] = Σ_{u→v, u ∈ S} x[u]``, which on the pull layout
    (``A[v, u] = 1`` iff edge u→v) is ``A @ (x ⊙ 1_S)``: ``x`` masked to
    the selected source column-blocks (``src_cb``, a [n_cb] indicator),
    then :func:`block_spmv_active_bucketed` over the candidate destination
    row-blocks (``active_ids`` compacted, −1-padded; ``n_active`` the
    device count).  Same output contract: rows of blocks outside
    ``active_ids`` are UNDEFINED — mask with the candidate indicator."""
    src_rows = src_cb[:, None].expand(-1, mat.block).reshape(-1)
    xm = torch.where(src_rows[:x.shape[0]], x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    return block_spmv_active_bucketed(mat, xm, active_ids, n_active,
                                      semiring="sum")


def block_adjacency(mat: BlockSparse) -> torch.Tensor:
    """Boolean [n_rb, n_cb] tile-presence matrix: which row-blocks own a tile
    in each column-block (candidate-block selection for the OR-pass)."""
    occ = mat.tile_cols >= 0
    rb = torch.arange(mat.n_rb, device=mat.device)[:, None].expand(
        occ.shape)
    cb = torch.where(occ, mat.tile_cols.long(), mat.n_cb)
    out = torch.zeros((mat.n_rb, mat.n_cb + 1), dtype=torch.bool,
                      device=mat.device)
    out[rb, cb] = True
    return out[:, :mat.n_cb]


def pagerank_pull_step(mat: BlockSparse, ranks: torch.Tensor,
                       inv_out_deg: torch.Tensor, n: int, *,
                       alpha: float = 0.85) -> torch.Tensor:
    """One PageRank pull iteration with the tile SpMV:
    r' = (1-α)/n + α · A @ (r ⊙ 1/outdeg).  A[v,u] = 1 iff edge u→v."""
    contrib = ranks * inv_out_deg
    pulled = block_spmv(mat, contrib, semiring="sum")
    return (1.0 - alpha) / n + alpha * pulled


def frontier_expand_op(mat_t: BlockSparse, changed: torch.Tensor
                       ) -> torch.Tensor:
    """DF expansion: indicator of out-neighbors of ``changed`` vertices.
    ``mat_t`` must hold A[v,u]=1 iff edge u→v (same layout as the pull)."""
    y = block_spmv(mat_t, changed.to(mat_t.tiles.dtype), semiring="or")
    return y.to(torch.float32)
