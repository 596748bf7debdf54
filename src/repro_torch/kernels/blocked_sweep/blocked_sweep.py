"""One Gauss–Seidel sweep of the blocked engine: a hand-written CUDA kernel
for Hopper, plus its plain PyTorch version.

Ports ``src/repro/core/blocked.py::sweep``, a jitted ``lax.scan`` over the
compacted block slots (no Pallas kernel): slot *j* reads the ranks,
``affected`` and ``RC`` that slots *< j* wrote.

* :func:`blocked_sweep_cuda` — the CUDA C++ kernel in
  ``csrc/blocked_sweep.cu`` (``sm_90a``): one thread block whose producer
  warps stage the next slots into a shared-memory ring while its consumer
  warps finish the current one, in slot order (the note in the source
  states the hazard rule that keeps it exact), built at first use by
  :mod:`repro_torch.kernels.nvcc` and bound through ``ctypes``;
* :func:`blocked_sweep_plain` — the reference's scan written slot by slot
  with tensor ops, in the same summation order.

:func:`blocked_sweep` picks between them by the device of ``R``: a CUDA
tensor always goes to the kernel (a build or launch failure raises; nothing
falls back), a CPU tensor to the plain version.

A :class:`SweepGraph` addresses each block's edge slices through
``in_lo``/``in_len`` and ``out_lo``/``out_len``: the snapshot's own CSR
(:func:`repro_torch.core.blocked.sweep_graph` without a pager), or the
bounded slab an ``EdgePager`` staged the active blocks into, in which a
vertex's in-edges start at ``vptr[v] − in_block_ptr[b] + in_lo[b]``.  Both
routes sum over the slice in the same order either way, so a paged sweep
is bit-identical to an unpaged one.

Both update ``R``, ``affected`` and ``rc`` in place (the reference's carry
is immutable; here the sweep owns its state) and return ``(maxdr [1],
edges [K] int32)``.  ``read`` is ``R`` itself in LF mode and, in BB mode, a
copy of ``R`` taken before the sweep: a BB sweep reading the ``R`` it writes
would be Gauss–Seidel, so passing ``R`` with ``jacobi=True`` raises.

The CUDA wrapper counts its launches in ``blocked_sweep_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc

_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}
MAX_BLOCK = 1024
_INT32 = ("slot_ids", "in_block_ptr", "in_lo", "in_len", "out_lo", "out_len",
          "vptr", "src", "dst", "osrc", "odst")

_SRC = Path(__file__).resolve().parent / "csrc" / "blocked_sweep.cu"


@dataclasses.dataclass(frozen=True)
class SweepGraph:
    """The arrays a sweep reads, on one device.  ``in_block_ptr`` and
    ``vptr`` are each block's and each vertex's in-edge range in the
    snapshot's dst-sorted edges; block b's in-edge slice is
    ``src/dst[in_lo[b] : in_lo[b] + in_len[b]]`` and its out-edge slice
    ``osrc/odst[out_lo[b] : out_lo[b] + out_len[b]]`` (the snapshot's CSR,
    or a pager's slab); ``inv_deg`` is ``1 / out_deg`` on the valid
    vertices, 0 on the padding and at the phantom entry ``n_pad``, in the
    rank dtype."""
    block: int
    n_pad: int
    in_block_ptr: torch.Tensor    # [n_blocks+1] i32
    in_lo: torch.Tensor           # [n_blocks] i32
    in_len: torch.Tensor          # [n_blocks] i32
    out_lo: torch.Tensor          # [n_blocks] i32
    out_len: torch.Tensor         # [n_blocks] i32
    vptr: torch.Tensor            # [n_pad+1] i32
    src: torch.Tensor             # in-edge slices, dst-sorted within each
    dst: torch.Tensor
    osrc: torch.Tensor            # out-edge slices, src-sorted within each
    odst: torch.Tensor
    inv_deg: torch.Tensor         # [n_pad+1] rank dtype
    valid: torch.Tensor           # [n_pad] bool


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # (dtype, B, tile, expand, K, n_pad), slot_ids, slot_mask, in_blk,
    # in_lo, in_len, out_lo, out_len, vptr, src, osrc, odst, inv_deg, valid,
    # R, read, affected, rc, (alpha, base_rank, tau, tau_f), maxdr, edges,
    # scratch, stream
    lib.blocked_sweep_launch.argtypes = ([i32] * 6 + [ptr] * 17 + [f64] * 4
                                         + [ptr] * 4)
    lib.blocked_sweep_launch.restype = i32
    lib.blocked_sweep_error_string.argtypes = [i32]
    lib.blocked_sweep_error_string.restype = ctypes.c_char_p


_Library = nvcc.Library(_SRC, "blocked_sweep", _bind)


def library() -> ctypes.CDLL:
    """Build (at first use, keyed by a hash of the source) and load the
    kernel library.  Raises if the build fails; never falls back."""
    return _Library.load()


def builds() -> int:
    """Loads of this library made by this process (1 after the first CUDA
    launch, 0 on the CPU)."""
    return _Library.builds


# ---------------------------------------------------------------------------
# operand checks (both routes)
# ---------------------------------------------------------------------------

def _check(sg: SweepGraph, R, read, affected, rc, slot_ids, slot_mask,
           jacobi: bool, tile: int) -> None:
    if not 1 <= sg.block <= MAX_BLOCK:
        raise ValueError(f"block={sg.block} outside [1, {MAX_BLOCK}]")
    if tile < 1:
        raise ValueError(f"tile={tile} must be > 0")
    if jacobi and read.data_ptr() == R.data_ptr():
        raise ValueError(
            "a BB (jacobi) sweep must read a copy of R taken before the "
            "sweep: R is written in place, and reading it would make the "
            "sweep Gauss–Seidel")
    n_pad = sg.n_pad
    n_blocks = n_pad // sg.block
    shapes = {"R": (R, (n_pad,)), "read": (read, (n_pad,)),
              "in_block_ptr": (sg.in_block_ptr, (n_blocks + 1,)),
              **{name: (getattr(sg, name), (n_blocks,))
                 for name in ("in_lo", "in_len", "out_lo", "out_len")},
              "affected": (affected, (n_pad + 1,)),
              "rc": (rc, (n_pad + 1,)),
              "slot_mask": (slot_mask, tuple(slot_ids.shape)),
              "inv_deg": (sg.inv_deg, (n_pad + 1,)),
              "vptr": (sg.vptr, (n_pad + 1,)), "valid": (sg.valid, (n_pad,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if slot_ids.dim() != 1:
        raise ValueError("slot_ids must be 1-D")
    if read.dtype != R.dtype or sg.inv_deg.dtype != R.dtype:
        raise ValueError(f"read and inv_deg must have R's dtype {R.dtype}")
    for name, t in (("affected", affected), ("rc", rc),
                    ("slot_mask", slot_mask), ("valid", sg.valid)):
        if t.dtype != torch.bool:
            raise ValueError(f"{name} must be bool, got {t.dtype}")


def _scalars(dtype, n: int, alpha, tau, tau_f):
    """alpha, base_rank = (1 − alpha) / n, tau, tau_f, each rounded to the
    rank dtype as the reference's (``jnp.asarray(x, dtype)``)."""
    a = torch.tensor(float(alpha), dtype=dtype)
    return (float(a), float((1.0 - a) / n),
            float(torch.tensor(float(tau), dtype=dtype)),
            float(torch.tensor(float(tau_f), dtype=dtype)))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def blocked_sweep_cuda(sg: SweepGraph, R, read, affected, rc, slot_ids,
                       slot_mask, *, n: int, alpha, tau, tau_f, tile: int,
                       expand: bool, jacobi: bool):
    """The kernel: one in-order sweep over ``slot_ids`` (K slots) on the
    card.  Raises on a non-CUDA operand or a dtype other than f32/f64."""
    _check(sg, R, read, affected, rc, slot_ids, slot_mask, jacobi, tile)
    if R.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rank dtype {R.dtype} unsupported by the sweep "
                         f"kernel; expected one of {list(_KERNEL_DTYPES)}")
    if R.device.type != "cuda":
        raise ValueError(f"R must lie on a CUDA device, got {R.device}")
    named = {"R": R, "read": read, "affected": affected, "rc": rc,
             "slot_ids": slot_ids, "slot_mask": slot_mask,
             **{f.name: getattr(sg, f.name)
                for f in dataclasses.fields(sg)
                if isinstance(getattr(sg, f.name), torch.Tensor)}}
    for name, t in named.items():
        if t.device != R.device:
            raise ValueError(f"{name} must lie on R's device ({R.device}), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in _INT32 and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    K = int(slot_ids.shape[0])
    maxdr = torch.empty(1, dtype=R.dtype, device=R.device)
    edges = torch.empty(K, dtype=torch.int32, device=R.device)
    # the active slots' ids, blocks and first ring items, and each block's
    # slot
    scratch = torch.empty(3 * K + 1 + sg.n_pad // sg.block,
                          dtype=torch.int32, device=R.device)
    a, base, t, tf = _scalars(R.dtype, n, alpha, tau, tau_f)
    lib = library()
    rc_code = lib.blocked_sweep_launch(
        _KERNEL_DTYPES[R.dtype], sg.block, tile, int(expand), K, sg.n_pad,
        slot_ids.data_ptr(), slot_mask.data_ptr(), sg.in_block_ptr.data_ptr(),
        sg.in_lo.data_ptr(), sg.in_len.data_ptr(), sg.out_lo.data_ptr(),
        sg.out_len.data_ptr(), sg.vptr.data_ptr(), sg.src.data_ptr(),
        sg.osrc.data_ptr(), sg.odst.data_ptr(), sg.inv_deg.data_ptr(),
        sg.valid.data_ptr(), R.data_ptr(), read.data_ptr(),
        affected.data_ptr(), rc.data_ptr(), a, base, t, tf,
        maxdr.data_ptr(), edges.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(R.device).cuda_stream)
    if rc_code != 0:
        msg = lib.blocked_sweep_error_string(rc_code).decode()
        raise RuntimeError(f"blocked_sweep launch failed: CUDA error "
                           f"{rc_code} ({msg})")
    nvcc.count_launch(blocked_sweep_cuda)
    return maxdr, edges


blocked_sweep_cuda.launches = 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def blocked_sweep_plain(sg: SweepGraph, R, read, affected, rc, slot_ids,
                        slot_mask, *, n: int, alpha, tau, tau_f, tile: int,
                        expand: bool, jacobi: bool):
    """The reference's ``lax.scan`` slot by slot: per slot, each ``tile``
    of the block's in-edge slice is summed per vertex (``index_add_`` into
    zeros, in edge order on the CPU) and added to the running sum, then the
    block's ranks, RC, the running max and — when some vertex moved more
    than ``tau_f`` — the OR expansion to its out-neighbours.  Reads the slot
    table and the block slices' places on the host once per call."""
    _check(sg, R, read, affected, rc, slot_ids, slot_mask, jacobi, tile)
    B, n_pad, dt, dev = sg.block, sg.n_pad, R.dtype, R.device
    a, base_r, t, tf = (torch.tensor(x, dtype=dt, device=dev)
                        for x in _scalars(dt, n, alpha, tau, tau_f))
    ids = slot_ids.cpu().numpy()
    mask = slot_mask.cpu().numpy()
    ilo, ilen, olo_h, olen = (t.cpu().numpy().astype(np.int64) for t in (
        sg.in_lo, sg.in_len, sg.out_lo, sg.out_len))
    K = len(ids)
    edges = np.zeros(K, np.int64)
    maxdr = torch.zeros((), dtype=dt, device=dev)
    for j in range(K):
        b = int(ids[j])
        if not mask[j] or b < 0:
            continue
        base = b * B
        lo, hi = int(ilo[b]), int(ilo[b] + ilen[b])
        blk = slice(base, base + B)
        s = sg.src[lo:hi].long()
        c = read[s.clamp(max=n_pad - 1)] * sg.inv_deg[s]
        lidx = sg.dst[lo:hi].long() - base
        n_tiles = (hi - lo + tile - 1) // tile
        acc = torch.zeros(B, dtype=dt, device=dev)
        for k in range(n_tiles):
            part = torch.zeros(B, dtype=dt, device=dev)
            acc = acc + part.index_add_(0, lidx[k * tile:(k + 1) * tile],
                                        c[k * tile:(k + 1) * tile])
        r_new = base_r + a * acc
        old = R[blk].clone()
        upd = affected[blk] & sg.valid[blk]
        r_fin = torch.where(upd, r_new, old)
        dr = torch.where(upd, (r_fin - old).abs(), torch.zeros_like(old))
        R[blk] = r_fin
        rc[blk] = torch.where(upd, dr > t, rc[blk])
        maxdr = torch.maximum(maxdr, dr.max())
        edges[j] = hi - lo
        if not expand:
            continue
        changed = upd & (dr > tf)
        if not bool(changed.any()):
            continue
        olo, ohi = int(olo_h[b]), int(olo_h[b] + olen[b])
        lsrc = (sg.osrc[olo:ohi].long() - base).clamp(0, B - 1)
        tgt = torch.where(changed[lsrc], sg.odst[olo:ohi].long(), n_pad)
        affected[tgt] = True
        rc[tgt] = True
        if (ohi - olo) % tile:                 # lanes past the range's end
            affected[n_pad] = True
            rc[n_pad] = True
        edges[j] += ohi - olo
    return (maxdr.reshape(1),
            torch.as_tensor(edges.astype(np.int32), device=dev))


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------

def blocked_sweep(sg: SweepGraph, R, read, affected, rc, slot_ids, slot_mask,
                  *, n: int, alpha, tau, tau_f, tile: int, expand: bool,
                  jacobi: bool):
    """The kernel on a CUDA ``R``, its plain version on a CPU ``R``."""
    kw = dict(n=n, alpha=alpha, tau=tau, tau_f=tau_f, tile=tile,
              expand=expand, jacobi=jacobi)
    if R.device.type == "cuda":
        return blocked_sweep_cuda(sg, R, read, affected, rc, slot_ids,
                                  slot_mask, **kw)
    if R.device.type == "cpu":
        return blocked_sweep_plain(sg, R, read, affected, rc, slot_ids,
                                   slot_mask, **kw)
    raise ValueError(f"the blocked sweep runs on CUDA (kernel) or CPU (plain "
                     f"version); got a tensor on {R.device}")
