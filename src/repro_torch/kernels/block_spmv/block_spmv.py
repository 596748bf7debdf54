"""Block-sparse tile SpMV kernels: hand-written CUDA for Hopper, plus their
plain PyTorch versions.

Ports ``src/repro/kernels/block_spmv/block_spmv.py``.  The two TPU kernels
there (``block_spmv_pallas`` and ``block_spmv_active_pallas``) become

* :func:`block_spmv_cuda` / :func:`block_spmv_active_cuda` — wrappers around
  the CUDA C++ kernels in ``csrc/block_spmv.cu`` (``sm_90a``), built with
  ``nvcc`` at first use into ``build/repro_torch_kernels/`` (keyed by a hash
  of the source) and bound through ``ctypes``.  They read the pool's packed
  nonzero index (``ops.PackedIndex``: the tensors ``off``, ``cnt``,
  ``row``, ``col``, ``val``), never the dense tiles;
* :func:`block_spmv_plain` / :func:`block_spmv_active_plain` — gather +
  batched matvec over the dense tiles (the analogue of
  ``ops._block_spmv_xla`` / ``ops._block_spmv_active_xla``).

:func:`tile_spmv` / :func:`tile_spmv_active` pick between them by the device
of the tensors they are given: a CUDA tensor always goes to the kernel (a
build or launch failure raises; nothing falls back), a CPU tensor to the
plain version, anything else raises.

Semirings: ``sum`` (``y = A @ x``) and ``or`` (``y = 1`` where any slot's
partial product is positive, else 0 — a 0/1 indicator whatever the tile
values).  Slots whose ``tile_cols`` entry is −1 contribute nothing wherever
they sit in the row.  The active variants compute only the row-blocks named
in ``active_ids`` (−1 entries are skipped; on the card, entries from the
device count ``n_active`` on are not computed); the CUDA kernel leaves the
rows of every other block undefined, so callers mask them.

Each CUDA wrapper counts its launches in a plain ``launches`` attribute
(``block_spmv_cuda.launches``) — a run resets and reads it to show that its
path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

SEMIRINGS = ("sum", "or")
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
MAX_BLOCK = 256

_SRC = Path(__file__).resolve().parent / "csrc" / "block_spmv.cu"


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f64 for f64 inputs, f32 for f32 and bf16."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # (dtype, semiring, B, mt, n_list), [active_ids, n_active,] tile_idx,
    # tile_cols, the index's off, cnt, row, col, val, x, y, stream
    lib.block_spmv_launch.argtypes = [i32] * 5 + [ptr] * 10
    lib.block_spmv_launch.restype = i32
    lib.block_spmv_active_launch.argtypes = [i32] * 5 + [ptr] * 12
    lib.block_spmv_active_launch.restype = i32
    lib.block_spmv_error_string.argtypes = [i32]
    lib.block_spmv_error_string.restype = ctypes.c_char_p


_Library = nvcc.Library(_SRC, "block_spmv", _bind)


def library() -> ctypes.CDLL:
    """Build (at first use, keyed by a hash of the source) and load the
    kernel library.  Raises if the build fails; never falls back."""
    return _Library.load()


def builds() -> int:
    """Loads of this library made by this process (1 after the first CUDA
    launch, 0 on the CPU)."""
    return _Library.builds


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.block_spmv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


_INDEX_DTYPES = {"off": torch.int32, "cnt": torch.int32,
                 "row": torch.uint8, "col": torch.uint8}


def _check_operands(tile_idx, tile_cols, index, x, block, max_tiles,
                    semiring, active_ids=None, n_active=None):
    if semiring not in SEMIRINGS:
        raise ValueError(f"semiring={semiring!r}; expected one of "
                         f"{SEMIRINGS}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block={block} outside [1, {MAX_BLOCK}]")
    if x.device.type != "cuda":
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    if index is None:
        raise ValueError("the CUDA kernels read the packed index; pass the "
                         "BlockSparse's index")
    named = [("tile_idx", tile_idx), ("tile_cols", tile_cols), ("x", x)]
    named += [(f, getattr(index, f)) for f in (*_INDEX_DTYPES, "val")]
    if active_ids is not None:
        named.append(("active_ids", active_ids))
    if n_active is not None:
        named.append(("n_active", n_active))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device "
                             f"({x.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = {"tile_idx": torch.int32, "tile_cols": torch.int32,
            "active_ids": torch.int32, "n_active": torch.int64,
            **_INDEX_DTYPES}
    for name, t in named:
        if name in want and t.dtype != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {t.dtype}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x dtype {x.dtype} unsupported; expected one of "
                         f"{list(_KERNEL_DTYPES)}")
    if index.val.dtype != x.dtype:
        raise ValueError(f"index values dtype {index.val.dtype} must equal "
                         f"x dtype {x.dtype}")
    n_rb = tile_cols.shape[0]
    if tile_cols.dim() != 2 or tile_cols.shape[1] != max_tiles:
        raise ValueError(f"tile_cols shape {tuple(tile_cols.shape)} != "
                         f"(n_rb, {max_tiles})")
    if tile_idx.shape != (n_rb * max_tiles,):
        raise ValueError(f"tile_idx shape {tuple(tile_idx.shape)} != "
                         f"({n_rb * max_tiles},)")
    entries = index.val.shape
    if (index.off.dim() != 1 or index.cnt.shape != index.off.shape
            or len(entries) != 1 or index.row.shape != entries
            or index.col.shape != entries):
        raise ValueError("packed index shapes disagree: off/cnt [cap], "
                         "row/col/val [entries]")
    if x.dim() != 1 or x.shape[0] % block:
        raise ValueError(f"x shape {tuple(x.shape)} is not a whole number "
                         f"of {block}-blocks")
    if active_ids is not None and active_ids.dim() != 1:
        raise ValueError("active_ids must be 1-D")
    if n_active is not None and n_active.numel() != 1:
        raise ValueError("n_active must hold one count")
    return n_rb


def _index_ptrs(index):
    return (index.off.data_ptr(), index.cnt.data_ptr(),
            index.row.data_ptr(), index.col.data_ptr(),
            index.val.data_ptr())


def block_spmv_cuda(tile_idx: torch.Tensor, tile_cols: torch.Tensor, index,
                    x: torch.Tensor, *, block: int, max_tiles: int,
                    semiring: str = "sum") -> torch.Tensor:
    """CUDA kernel #1: y [n_rb*B] = A @ x over every row-block's slot list,
    read from the packed ``index`` (replaces ``block_spmv_pallas``).  Raises
    on a non-CUDA operand."""
    n_rb = _check_operands(tile_idx, tile_cols, index, x, block, max_tiles,
                           semiring)
    lib = library()
    y = torch.empty(n_rb * block, dtype=x.dtype, device=x.device)
    rc = lib.block_spmv_launch(
        _KERNEL_DTYPES[x.dtype], SEMIRINGS.index(semiring), block,
        max_tiles, n_rb, tile_idx.data_ptr(), tile_cols.data_ptr(),
        *_index_ptrs(index), x.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(lib, rc, "block_spmv")
    nvcc.count_launch(block_spmv_cuda)
    return y


block_spmv_cuda.launches = 0


def block_spmv_active_cuda(active_ids: torch.Tensor, tile_idx: torch.Tensor,
                           tile_cols: torch.Tensor, index, x: torch.Tensor,
                           *, block: int, max_tiles: int,
                           semiring: str = "sum",
                           out: Optional[torch.Tensor] = None,
                           n_active: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """CUDA kernel #2: the row-blocks named in ``active_ids`` (−1 skipped
    wherever it sits) of y = A @ x, read from the packed ``index`` (replaces
    ``block_spmv_active_pallas``).  ``n_active``, an int64 count on the
    card, ends the walk of the list on the device (never read back).  Rows
    of every other block keep whatever ``out`` held (uninitialised memory
    when ``out`` is None) — callers mask them."""
    n_rb = _check_operands(tile_idx, tile_cols, index, x, block, max_tiles,
                           semiring, active_ids, n_active)
    if active_ids.shape[0] > n_rb:
        raise ValueError(f"active_ids length {active_ids.shape[0]} > n_rb "
                         f"{n_rb}")
    if out is None:
        out = torch.empty(n_rb * block, dtype=x.dtype, device=x.device)
    elif (out.shape != (n_rb * block,) or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous [n_rb*B] tensor of x's "
                         "dtype on x's device")
    lib = library()
    rc = lib.block_spmv_active_launch(
        _KERNEL_DTYPES[x.dtype], SEMIRINGS.index(semiring), block,
        max_tiles, active_ids.shape[0], active_ids.data_ptr(),
        None if n_active is None else n_active.data_ptr(),
        tile_idx.data_ptr(), tile_cols.data_ptr(), *_index_ptrs(index),
        x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(lib, rc, "block_spmv_active")
    nvcc.count_launch(block_spmv_active_cuda)
    return out


block_spmv_active_cuda.launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (same layout, same semantics)
# ---------------------------------------------------------------------------

_PLAIN_GATHER_BYTES = 1 << 26    # bound on one gathered [k, g, B, B] group


def _unpack(index, ids: torch.Tensor, block: int,
            dtype: torch.dtype) -> torch.Tensor:
    """Dense tiles ``[*ids.shape, B, B]`` of the tile ids ``ids`` rebuilt
    from the packed ``index`` (the plain versions' reading of a matrix that
    holds no dense tiles, as the tiered slab view)."""
    u = ids.reshape(-1).long()
    cnt = index.cnt[u].long()
    out = torch.zeros(u.shape[0] * block * block, dtype=dtype,
                      device=ids.device)
    total = int(cnt.sum())
    if total:
        owner = torch.repeat_interleave(
            torch.arange(u.shape[0], device=ids.device), cnt)
        first = (cnt.cumsum(0) - cnt)[owner]
        pos = (index.off[u].long()[owner]
               + torch.arange(total, device=ids.device) - first)
        at = ((owner * block + index.row[pos].long()) * block
              + index.col[pos].long())
        out[at] = index.val[pos].to(dtype)
    return out.reshape(*ids.shape, block, block)


def _rows_plain(rb: torch.Tensor, tile_idx: torch.Tensor,
                tile_cols: torch.Tensor, tiles: torch.Tensor,
                x: torch.Tensor, block: int, max_tiles: int,
                semiring: str, index=None,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[len(rb), B] products of the listed row-blocks: gather a group of
    slots' tiles and x-slices, batched matvec, fold into the accumulator.
    Groups of slots are sized so one gather stays under 64 MB whatever
    ``len(rb)`` and ``max_tiles`` are.  A zero-size ``tiles`` with an
    ``index`` reads each gathered tile from the packed index instead, and
    then only for the rows ``live`` marks (the others come back as zero;
    the groups stay those of all ``len(rb)`` rows)."""
    if semiring not in SEMIRINGS:
        raise ValueError(f"semiring={semiring!r}; expected one of "
                         f"{SEMIRINGS}")
    acc_t = _acc_dtype(x.dtype)
    k = rb.shape[0]
    xb = x.reshape(-1, block).to(acc_t)
    cols = tile_cols.long()[rb]                            # [k, mt]
    idx = tile_idx.long().reshape(-1, max_tiles)[rb]       # [k, mt]
    acc = torch.zeros(k, block, dtype=acc_t, device=x.device)
    tile_bytes = block * block * torch.finfo(acc_t).bits // 8
    g = max(1, min(max_tiles, _PLAIN_GATHER_BYTES // max(1, k * tile_bytes)))
    packed = tiles.shape[0] == 0 and index is not None
    if packed:
        sel = (torch.arange(k, device=x.device) if live is None
               else live.nonzero().squeeze(1))
    for j in range(0, max_tiles, g):
        c = cols[:, j:j + g]
        X = torch.where((c >= 0)[..., None], xb[c.clamp(min=0)], 0)
        if packed:
            part = torch.zeros(k, c.shape[1], block, dtype=acc_t,
                               device=x.device)
            T = _unpack(index, idx[sel, j:j + g], block, acc_t)
            part[sel] = torch.matmul(T, X[sel][..., None])[..., 0]
        else:
            T = tiles[idx[:, j:j + g]].to(acc_t)          # [k, g, B, B]
            part = torch.matmul(T, X[..., None])[..., 0]   # [k, g, B]
        if semiring == "sum":
            acc += part.sum(dim=1)
        else:
            acc = torch.maximum(acc, part.clamp(max=1).amax(dim=1))
    if semiring == "or":
        acc = (acc > 0).to(acc_t)
    return acc.to(x.dtype)


def block_spmv_plain(tile_idx: torch.Tensor, tile_cols: torch.Tensor,
                     tiles: torch.Tensor, x: torch.Tensor, *, block: int,
                     max_tiles: int, semiring: str = "sum",
                     index=None) -> torch.Tensor:
    """Plain version of :func:`block_spmv_cuda` (the analogue of
    ``ops._block_spmv_xla``).  With no dense tiles (a zero-size ``tiles``)
    it reads the packed ``index``."""
    n_rb = tile_cols.shape[0]
    rb = torch.arange(n_rb, device=x.device)
    return _rows_plain(rb, tile_idx, tile_cols, tiles, x, block, max_tiles,
                       semiring, index).reshape(-1)


def block_spmv_active_plain(active_ids: torch.Tensor, tile_idx: torch.Tensor,
                            tile_cols: torch.Tensor, tiles: torch.Tensor,
                            x: torch.Tensor, *, block: int, max_tiles: int,
                            semiring: str = "sum", index=None
                            ) -> torch.Tensor:
    """Plain version of :func:`block_spmv_active_cuda` (the analogue of
    ``ops._block_spmv_active_xla``).  Rows of blocks outside the list come
    back as zero here; callers must not rely on that.  With no dense tiles
    it reads the packed ``index``."""
    n_rb = tile_cols.shape[0]
    ids = active_ids.long()
    y = _rows_plain(ids.clamp(min=0), tile_idx, tile_cols, tiles, x, block,
                    max_tiles, semiring, index, live=ids >= 0)
    out = torch.zeros(n_rb + 1, block, dtype=x.dtype, device=x.device)
    out[torch.where(ids >= 0, ids, n_rb)] = y      # −1 slots → trash row
    return out[:n_rb].reshape(-1)


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def _route(x: torch.Tensor) -> str:
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"tile SpMV runs on CUDA (kernel) or CPU (plain "
                     f"version); got a tensor on {x.device}")


def tile_spmv(tile_idx, tile_cols, tiles, x, *, block: int, max_tiles: int,
              semiring: str = "sum", index=None) -> torch.Tensor:
    """Kernel #1 over ``index`` on a CUDA ``x``, its plain version over
    ``tiles`` on a CPU ``x`` (over ``index`` when ``tiles`` is empty)."""
    if _route(x) == "cuda":
        return block_spmv_cuda(tile_idx, tile_cols, index, x, block=block,
                               max_tiles=max_tiles, semiring=semiring)
    return block_spmv_plain(tile_idx, tile_cols, tiles, x, block=block,
                            max_tiles=max_tiles, semiring=semiring,
                            index=index)


def tile_spmv_active(active_ids, tile_idx, tile_cols, tiles, x, *,
                     block: int, max_tiles: int, semiring: str = "sum",
                     index=None, n_active=None) -> torch.Tensor:
    """Kernel #2 over ``index`` on a CUDA ``x`` (stopping at the device
    count ``n_active``), its plain version over ``tiles`` on a CPU ``x``
    (over ``index`` when ``tiles`` is empty)."""
    if _route(x) == "cuda":
        return block_spmv_active_cuda(
            active_ids, tile_idx, tile_cols, index, x, block=block,
            max_tiles=max_tiles, semiring=semiring, n_active=n_active)
    return block_spmv_active_plain(active_ids, tile_idx, tile_cols, tiles, x,
                                   block=block, max_tiles=max_tiles,
                                   semiring=semiring, index=index)
