"""State integrity under silent corruption — the corruption fault domain
(ports ``src/repro/core/integrity.py``: ``INTEGRITY_CHECKS``,
``REPAIR_RUNGS``, ``INVARIANT_FIELDS``, ``IntegrityConfig``,
``invariant_vec``, ``chunked_crc32``, ``compare_digests``,
``tile_row_sums``, ``check_slot_tables``, ``flipped_float``,
``exponent_bit`` and ``IntegrityReport``).

Three layers, as in the reference:

* **Invariant checks on the live iterate** (:func:`invariant_vec`): mass
  conservation |Σx − 1|, non-negativity, finiteness and the L∞ drift from
  the last verified iterate, reduced on the iterate's device.  The pull
  driver stacks the four terms onto each poll's stats vector, so the
  fused per-drive check costs no host sync of its own.
* **Checksummed device state**: chunked CRC32 digests of the operand
  mirrors against their host twins (:func:`compare_digests`, over host
  copies), the per-row-block sum check (every stored pull-matrix entry is
  1.0, so the live entries of row-block *i* sum to exactly ``rb_in[i]``)
  and the slot tables' structure against the block adjacency
  (:func:`check_slot_tables`).
* **A repair ladder** driven by ``PageRankSession.verify``: ``frontier`` →
  ``rebuild`` → ``restore``.

What the port adds, because its CUDA kernels read the packed nonzero index
(``ops.PackedIndex``) and never the dense tiles:

* the sum check sums the live entries of the index per row-block (one
  segment sum per tile over its own ``off : off + cnt`` range) as well as
  the dense pool (:func:`tile_row_sums`), and flags the union of both;
* a port check, ``packed_index``: the index's ranges are in bounds and
  hold only live entries, and its per-vertex row and column sums equal the
  dense pool's — a flipped ``row``/``col``/``off``/``cnt`` byte that only
  moves an entry inside its tile leaves every row-block sum as it was.
  :func:`check_packed_index` walks the index once for both;
* :func:`check_slot_tables` finds the reference's failures from sorted
  (row-block, column-block) keys, without its dense ``[n_rb, n_cb]``
  count grid (2.15 GB of host memory at n = 1M).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: Checks run by ``session.verify()``; ``packed_index`` is the port's.
INTEGRITY_CHECKS = ("rank_mass", "rank_negativity", "rank_finite",
                    "rank_drift", "mirror_digest", "tile_sums",
                    "slot_tables", "graph_digest", "packed_index")

#: Repair-ladder rungs, cheapest first.
REPAIR_RUNGS = ("frontier", "rebuild", "restore")

#: Fields of the fused invariant vector, in order.
INVARIANT_FIELDS = ("mass_error", "negative", "nonfinite", "drift")
N_INVARIANTS = len(INVARIANT_FIELDS)

#: |sum − count| above which a sum check flags (the counts are integers).
COUNT_TOL = 0.25


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """The ``EngineConfig(integrity=…)`` axis (field meanings as in
    ``repro.core.integrity.IntegrityConfig``).  ``mass_tol`` bounds
    |Σx − 1| on a converged iterate; the default 1e-6 suits n up to ~10⁴
    at τ = 1e-10 — scale it with n·τ for larger graphs.  ``drift_tol``
    bounds the L∞ movement of the ranks between drives (legitimately 0).
    ``scrub_interval_s`` paces the service scrubber (ROADMAP A 12);
    ``scrub_chunk_bytes`` sizes the CRC chunks; ``auto_repair`` lets a
    failed check climb the ladder; ``fused`` keeps the per-drive invariant
    check on."""
    mass_tol: float = 1e-6
    drift_tol: float = 1e-9
    scrub_interval_s: float = 0.25
    scrub_chunk_bytes: int = 1 << 20
    auto_repair: bool = True
    fused: bool = True

    def __post_init__(self):
        if not (self.mass_tol > 0):
            raise ValueError(f"mass_tol must be > 0, got {self.mass_tol}")
        if not (self.drift_tol > 0):
            raise ValueError(f"drift_tol must be > 0, got {self.drift_tol}")
        if not (self.scrub_interval_s > 0):
            raise ValueError("scrub_interval_s must be > 0, got "
                             f"{self.scrub_interval_s}")
        if int(self.scrub_chunk_bytes) < 64:
            raise ValueError("scrub_chunk_bytes must be >= 64, got "
                             f"{self.scrub_chunk_bytes}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def coerce(cls, value: Any) -> Optional["IntegrityConfig"]:
        """None | IntegrityConfig | kwargs-dict → IntegrityConfig (or
        None).  The dict form is what ``SessionStore`` meta round-trips."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(
            f"integrity must be an IntegrityConfig or a kwargs dict, got "
            f"{type(value).__name__}")


# ---------------------------------------------------------------------------
# invariant checks on the live iterate
# ---------------------------------------------------------------------------

def invariant_vec(R: torch.Tensor, R_ref: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """[mass_error, negative_count, nonfinite_count, linf_drift] of the
    iterate, reduced on its device (no host sync).  ``R_ref`` is the last
    verified iterate; pass ``R`` itself to make the drift term 0.  A
    non-finite entry is masked out of the mass and drift terms, so they stay
    informative beside the finite count.  Vectors of different lengths
    raise ``TypeError``, as the reference's broadcast does (a sharded
    session's baseline after a shrink, ROADMAP watch list 1)."""
    if R.shape != R_ref.shape:
        raise TypeError(f"invariant_vec got incompatible shapes for "
                        f"broadcasting: {tuple(R.shape)}, "
                        f"{tuple(R_ref.shape)}")
    zero = R.new_zeros(())
    finite = torch.isfinite(R)
    xf = torch.where(valid & finite, R, zero)
    mass_err = (xf.sum() - 1.0).abs()
    neg = ((xf < 0) & valid).sum()
    nonfinite = (valid & ~finite).sum()
    ref = torch.where(valid & torch.isfinite(R_ref), R_ref, zero)
    drift = (xf - ref).abs().max()
    return torch.stack([mass_err, neg.to(R.dtype), nonfinite.to(R.dtype),
                        drift])


# ---------------------------------------------------------------------------
# chunked checksums: device state vs host truth
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def chunked_crc32(arr, *, chunk_bytes: int = 1 << 20) -> Tuple[int, ...]:
    """CRC32 digest of an array (a tensor is copied to the host first) in
    fixed-size byte chunks, so a mismatch localizes the corrupted region."""
    b = np.ascontiguousarray(_host(arr)).tobytes()
    step = max(64, int(chunk_bytes))
    if not b:
        return (0,)
    return tuple(zlib.crc32(b[i:i + step]) & 0xFFFFFFFF
                 for i in range(0, len(b), step))


def compare_digests(device_arr, host_arr, *,
                    chunk_bytes: int = 1 << 20) -> List[int]:
    """Chunk indices where a device mirror's digest disagrees with its
    host-truth twin (empty list = clean).  The host side is cast to the
    device dtype first, so the comparison is value-exact."""
    a = _host(device_arr)
    b = _host(host_arr)
    if a.shape != b.shape:
        return [-1]
    da = chunked_crc32(a, chunk_bytes=chunk_bytes)
    db = chunked_crc32(b.astype(a.dtype, copy=False),
                       chunk_bytes=chunk_bytes)
    if len(da) != len(db):
        return [-1]
    return [i for i, (x, y) in enumerate(zip(da, db)) if x != y]


# ---------------------------------------------------------------------------
# the tile-pool sum check: the dense pool and the packed index
# ---------------------------------------------------------------------------

def _occupied(tile_cols: torch.Tensor, tile_idx: torch.Tensor):
    """(row-block, column-block, tile id) of every occupied slot."""
    n_rb, mt = tile_cols.shape
    occ = tile_cols >= 0
    rb = torch.arange(n_rb, device=tile_cols.device)[:, None].expand(
        n_rb, mt)[occ]
    return rb, tile_cols[occ].long(), tile_idx.reshape(n_rb, mt)[occ].long()


def tile_row_sums(mat) -> np.ndarray:
    """Per-row-block sum of the live tiles of the dense pool (what the plain
    versions read and ``ops.refresh_index`` re-packs from), over the slot
    tables the kernels read: one sum per pool tile on the pool's device,
    then one per row-block.  Every stored entry is 1.0, so row-block *i*
    must sum to ``rb_in[i]``."""
    tiles = mat.tiles
    n_rb = int(mat.tile_cols.shape[0])
    per_tile = tiles.reshape(tiles.shape[0], -1).sum(1)
    rb, _, tid = _occupied(mat.tile_cols, mat.tile_idx)
    out = torch.zeros(n_rb, dtype=tiles.dtype, device=tiles.device)
    out.index_add_(0, rb, per_tile[tid.clamp(0, tiles.shape[0] - 1)])
    return out.cpu().numpy()


def _entries(index, rb: torch.Tensor, cb: torch.Tensor, tid: torch.Tensor,
             block: int):
    """Every entry of the occupied tiles ``tid`` (rows ``rb``, columns
    ``cb``) as (row-block, column-block, in-tile row, in-tile col, value,
    in-range flag), walking each tile's own ``off : off + cnt`` range.
    Out-of-range offsets, counts, ids and places are clamped, and flagged.
    One host read: the number of entries."""
    cap = index.off.shape[0]
    e_cap = index.entry_capacity
    tid_ok = (tid >= 0) & (tid < cap)
    t = tid.clamp(0, cap - 1)
    cnt = index.cnt[t].long()
    off = index.off[t].long()
    t_ok = (tid_ok & (cnt >= 0) & (cnt <= block * block) & (off >= 0)
            & (off + cnt <= e_cap))
    cnt = torch.where(t_ok, cnt, torch.zeros_like(cnt))
    total = int(cnt.sum())
    owner = torch.repeat_interleave(
        torch.arange(len(t), device=t.device), cnt, output_size=total)
    first = cnt.cumsum(0) - cnt
    pos = off[owner] + torch.arange(total, device=t.device) - first[owner]
    row, col = index.row[pos].long(), index.col[pos].long()
    val = index.val[pos]
    e_ok = (row < block) & (col < block) & (val != 0)
    return rb[owner], cb[owner], row, col, val, bool(t_ok.all()) and \
        bool(e_ok.all())


def check_packed_index(mat) -> Tuple[np.ndarray, List[dict]]:
    """One walk of the packed index — what the CUDA kernels read — for both
    of its checks: ``(row_block_sums, problems)``.

    ``row_block_sums`` is the per-row-block sum of the index's live entries,
    one segment sum per tile over its own ``off : off + cnt`` range (never
    differences of a running sum, which one flipped exponent would make
    inexact everywhere after it); the sum check holds it to ``rb_in``.

    ``problems`` is the port's ``packed_index`` check: the packed index
    must be the dense pool it was packed from.  Every tile's range must lie
    inside the entry pool and hold only live entries with in-tile places,
    and the index's per-vertex row and column sums must equal the pool's.
    A flipped ``row``/``col``/``off``/``cnt`` byte that only moves an entry
    inside its tile leaves every row-block sum as it was but moves a
    vertex's sum.  The reference point is the pool, not host truth: the sum
    check already holds the pool to host truth, so damage to both copies
    (the ``tile`` kind) is the sum check's finding alone, as in the
    reference.  The walk reads the host twins of the slot tables
    (``tile_cols_h`` / ``tile_idx_h``), so a damaged device table is the
    slot check's finding, not this one's.  Failure dicts are in the
    ``_integrity_check`` shape: ``what: "range"``, or the vertex ``blocks``
    whose sums disagree."""
    B = mat.block
    n_rb = int(mat.n_rb)
    n_pad = n_rb * B
    tiles = mat.tiles
    dev = tiles.device
    tc = torch.as_tensor(np.asarray(mat.tile_cols_h), device=dev)
    ti = torch.as_tensor(np.asarray(mat.tile_idx_h), device=dev)
    rb, cb, tid = _occupied(tc, ti)
    guard = torch.tensor(n_pad, device=dev)
    # [pool, index] x [row, col] per-vertex sums, then the index's
    # per-row-block sums: one read back to the host for all of them
    sums = torch.zeros(2 * 2 * (n_pad + 1) + n_rb, dtype=tiles.dtype,
                       device=dev)
    vert = sums[:4 * (n_pad + 1)].view(2, 2, n_pad + 1)
    rb_sums = sums[4 * (n_pad + 1):]
    # the pool's: one row sum and one column sum per tile and in-tile place
    t = tid.clamp(0, tiles.shape[0] - 1)
    place = torch.arange(B, device=dev)
    v_row = torch.minimum(rb[:, None] * B + place, guard).reshape(-1)
    v_col = torch.minimum(cb[:, None] * B + place, guard).reshape(-1)
    vert[0, 0].index_add_(0, v_row, tiles.sum(2)[t].reshape(-1))
    vert[0, 1].index_add_(0, v_col, tiles.sum(1)[t].reshape(-1))
    # the index's: every entry of every occupied tile's range
    rbe, cbe, row, col, val, in_range = _entries(mat.index, rb, cb, tid, B)
    vert[1, 0].index_add_(0, torch.minimum(rbe * B + row, guard), val)
    vert[1, 1].index_add_(0, torch.minimum(cbe * B + col, guard), val)
    rb_sums.index_add_(0, rbe, val)
    host = sums.cpu().numpy()
    vert_h = host[:4 * (n_pad + 1)].reshape(2, 2, n_pad + 1)[:, :, :n_pad]
    bad = (np.abs(vert_h[0] - vert_h[1]) > COUNT_TOL).any(0)
    problems: List[dict] = []
    if not in_range:
        problems.append({"check": "packed_index", "what": "range"})
    if bad.any():
        problems.append({"check": "packed_index",
                         "blocks": np.unique(np.nonzero(bad)[0] // B)[:8]
                         .tolist()})
    return host[4 * (n_pad + 1):], problems


# ---------------------------------------------------------------------------
# slot-table structure
# ---------------------------------------------------------------------------

def check_slot_tables(tile_cols: np.ndarray, tile_idx: np.ndarray,
                      bmat: np.ndarray, tile_capacity: int) -> List[dict]:
    """Structural validation of the slot tables against the host
    block-adjacency truth: out-of-range columns or tile ids, duplicate
    columns in one row, occupancy that disagrees with ``bmat``.  The
    reference's failures (the same ``what`` values and the same first 8
    ``row_blocks``) from sorted (row-block, column-block) keys against
    ``bmat``'s nonzeros, instead of its dense ``[n_rb, n_cb]`` count
    grid."""
    problems: List[dict] = []
    tile_cols = _host(tile_cols)
    tile_idx = _host(tile_idx).reshape(tile_cols.shape)
    bmat = np.asarray(bmat, bool)
    n_rb, n_cb = bmat.shape
    occ = tile_cols >= 0
    if tile_cols.min(initial=0) < -1 or \
            (occ & (tile_cols >= n_cb)).any():
        problems.append({"check": "slot_tables", "what": "col_range"})
    tid = tile_idx[occ]
    if len(tid) and (tid.min() < 0 or tid.max() >= tile_capacity
                     or len(np.unique(tid)) != len(tid)):
        problems.append({"check": "slot_tables", "what": "tile_idx"})
    rb = np.nonzero(occ)[0].astype(np.int64)
    keys = rb * n_cb + np.clip(tile_cols[occ], 0, n_cb - 1)
    uniq = np.unique(keys)
    if len(uniq) != len(keys):
        problems.append({"check": "slot_tables", "what": "col_dup"})
    b_rb, b_cb = np.nonzero(bmat)
    truth = b_rb.astype(np.int64) * n_cb + b_cb
    mism = np.setxor1d(uniq, truth, assume_unique=True)
    if len(mism):
        problems.append({"check": "slot_tables", "what": "bmat_mismatch",
                         "row_blocks": np.unique(mism // n_cb)[:8]
                         .astype(int).tolist()})
    return problems


# ---------------------------------------------------------------------------
# corruption injection primitives
# ---------------------------------------------------------------------------

def flipped_float(value, bit: int) -> float:
    """``value`` with IEEE bit ``bit`` flipped (f32 or f64).  Exponent /
    sign bits (52..63 for f64) give the ≥ 2× perturbations the invariant
    and sum checks always catch."""
    dt = np.dtype(np.asarray(value).dtype)
    if dt.itemsize == 8:
        u = np.asarray(value, dt).view(np.uint64) ^ np.uint64(1 << bit)
        return float(u.view(dt))
    u = np.asarray(value, np.float32).view(np.uint32) ^ np.uint32(1 << bit)
    return float(u.view(np.float32))


def exponent_bit(dtype, rng: np.random.Generator) -> int:
    """A deterministic exponent-range bit index for ``dtype``."""
    if np.dtype(dtype).itemsize == 8:
        return int(rng.integers(52, 62))
    return int(rng.integers(23, 30))


# ---------------------------------------------------------------------------
# verify() result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IntegrityReport:
    """Result of one ``session.verify()`` pass: what was checked, what
    failed (before any repair), which ladder rungs ran, and whether the
    final state is clean.  ``split_s`` (each part of the detection pass)
    and ``rung_s`` (each applied rung alone, without its re-check) are the
    port's timings; ``to_dict`` keeps the reference's keys."""
    ok: bool
    checks_run: int
    failures: List[Dict[str, Any]]
    repairs: List[str]                  # rungs applied, in order
    mass_error: float
    drift: float
    wall_time_s: float
    split_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    rung_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": bool(self.ok),
            "checks_run": int(self.checks_run),
            "failures": list(self.failures),
            "repairs": list(self.repairs),
            "mass_error": float(self.mass_error),
            "drift": float(self.drift),
            "wall_time_s": round(float(self.wall_time_s), 6),
        }
