"""The walk engine's kernels: hand-written CUDA for Hopper, each with its
plain PyTorch version on the same layout.

* :func:`walk_regen` regenerates the walks named by a list of ids and folds
  the visit counters (ports ``src/repro/core/walk_engine.py::_regen_step``,
  a jitted ``lax.scan``, no Pallas kernel);
* :func:`walk_touch` finds the walks that visit a set of touched vertices
  and the reference's touched-walk mass in one pass over the walk buffer
  (it takes the place of the reference's host reverse index,
  ``WalkState._build_index`` and its upkeep in ``apply_batch``).

Each dispatches on the device of the walk buffer: a CUDA tensor always goes
to the kernel in ``csrc/walk.cu`` (built at first use by
:mod:`repro_torch.kernels.nvcc`; a build or launch failure raises, nothing
falls back), a CPU tensor to the plain version.  The layout, the draws and
the arithmetic are described in the CUDA source.  ``walk_regen``'s launch
shape comes from :func:`regen_launch` (a persistent grid whose warps take
ids 32 at a time).  The CUDA wrappers count their launches in
``walk_regen_cuda.launches`` and ``walk_touch_cuda.launches``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core import threefry
from repro_torch.kernels import nvcc

_SRC = Path(__file__).resolve().parent / "csrc" / "walk.cu"
# walks a plain-version pass handles at once (bounds its scratch memory)
PLAIN_CHUNK = 1 << 16
REGEN_WARPS = 8          # warps a block of walk_regen (kRegenThreads / 32)
REGEN_CHUNK = 32         # ids a warp takes from the list at a time, one a lane
                         # (fixed by the kernel: a warp's width)


@dataclass(frozen=True)
class RegenLaunch:
    """``walk_regen``'s launch: ``grid`` blocks of ``warps`` warps.  Warp g
    of the W = grid * warps takes chunks g, g + W, g + 2W, ... of
    ``REGEN_CHUNK`` consecutive list entries; its lanes take the chunk's ids as their walks
    end.  No shared memory at any L: a lane stages its row's open 16-byte
    quad in registers."""
    grid: int
    warps: int


def regen_launch(B: int, sms: int, blocks_per_sm: int) -> RegenLaunch:
    """The launch shape for ``B`` ids on a card of ``sms`` SMs that keeps
    ``blocks_per_sm`` blocks of ``REGEN_WARPS`` warps resident: one wave (a
    persistent grid) when the list has enough chunks, else one warp a
    chunk.  The row length does not enter it."""
    if B < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"regen_launch needs B >= 1, sms >= 1 and "
                         f"blocks_per_sm >= 1; got B={B}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}")
    n_chunks = -(-B // REGEN_CHUNK)
    warps = min(REGEN_WARPS, n_chunks)
    grid = min(sms * blocks_per_sm, -(-n_chunks // warps))
    return RegenLaunch(grid=grid, warps=warps)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # walks, counts, adj, deg, wids, (B, n, R, L, cap), alpha, (k0, k1),
    # steps, (grid, warps), stream
    lib.walk_regen_launch.argtypes = ([ptr] * 5 + [i32] * 5
                                      + [ctypes.c_double]
                                      + [ctypes.c_uint] * 2 + [ptr]
                                      + [i32] * 2 + [ptr])
    lib.walk_regen_launch.restype = i32
    # adj, cap, warps, blocks (out)
    lib.walk_regen_occupancy.argtypes = [ptr, i32, i32, ptr]
    lib.walk_regen_occupancy.restype = i32
    # walks, touched, nr, L, n, flags, mass, stream
    lib.walk_touch_launch.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr, ptr]
    lib.walk_touch_launch.restype = i32
    # k0, k1, x0, x1, m, y0, y1, stream
    lib.threefry_launch.argtypes = [ptr] * 4 + [i64] + [ptr] * 3
    lib.threefry_launch.restype = i32
    lib.walk_error_string.argtypes = [i32]
    lib.walk_error_string.restype = ctypes.c_char_p


_Library = nvcc.Library(_SRC, "walk", _bind)


def library() -> ctypes.CDLL:
    """Build (at first use, keyed by a hash of the source) and load the
    kernel library.  Raises if the build fails; never falls back."""
    return _Library.load()


def builds() -> int:
    """Loads of this library made by this process (1 after the first CUDA
    launch, 0 on the CPU)."""
    return _Library.builds


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.walk_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------
# operand checks (both routes)
# ---------------------------------------------------------------------------

def _check_int32(dev: torch.device, **named) -> None:
    for name, t in named.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} must lie on the walk buffer's device "
                             f"({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_regen(walks, counts, adj, deg, wids, R: int) -> None:
    _check_int32(walks.device, walks=walks, counts=counts, adj=adj, deg=deg,
                 wids=wids)
    n = counts.shape[0] - 1
    if walks.dim() != 2 or walks.shape[1] < 2:
        raise ValueError(f"walks must be [n*R+1, L>=2], got "
                         f"{tuple(walks.shape)}")
    if R < 1 or walks.shape[0] != n * R + 1:
        raise ValueError(f"walks has {walks.shape[0]} rows; n*R+1 = "
                         f"{n * R + 1} for n={n}, R={R}")
    if adj.dim() != 2 or adj.shape[0] != n + 1 or deg.shape != (n + 1,):
        raise ValueError(f"adj must be [n+1, cap] and deg [n+1] for n={n}")
    if wids.dim() != 1:
        raise ValueError("wids must be 1-D")


def _check_touch(walks, touched, n_walks: int) -> None:
    _check_int32(walks.device, walks=walks)
    if touched.dtype != torch.bool or touched.device != walks.device:
        raise ValueError("touched must be a bool tensor on the walk "
                         "buffer's device")
    if not 1 <= n_walks < walks.shape[0]:
        raise ValueError(f"n_walks={n_walks} outside [1, "
                         f"{walks.shape[0] - 1}]")


# ---------------------------------------------------------------------------
# walk_regen
# ---------------------------------------------------------------------------

# resident blocks an SM keeps, by (device, the kernel's adjacency variant)
_BLOCKS_PER_SM: Dict[Tuple[int, int, bool], int] = {}


def _regen_shape(lib, walks, adj, B: int) -> RegenLaunch:
    """:func:`regen_launch` for this card (its SM count) and this
    adjacency (the kernel's variant, whose registers set the occupancy)."""
    dev = walks.device
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, adj.shape[1], adj.data_ptr() % 16 == 0)
    if key not in _BLOCKS_PER_SM:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            code = lib.walk_regen_occupancy(adj.data_ptr(), adj.shape[1],
                                            REGEN_WARPS, ctypes.byref(out))
        _raise_on(lib, code, "walk_regen occupancy")
        _BLOCKS_PER_SM[key] = max(int(out.value), 1)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return regen_launch(B, sms, _BLOCKS_PER_SM[key])


def walk_regen_cuda(walks, counts, adj, deg, wids, *, R: int, alpha: float,
                    key: Tuple[int, int]) -> torch.Tensor:
    """The kernel: regenerate ``walks[wids]`` in place and fold ``counts``;
    returns the new rows' live entries as a 0-d int64 tensor on the card.
    ``alpha`` is the f32 alpha (as a float) and ``key`` the seed's
    ``threefry.prng_key``."""
    _check_regen(walks, counts, adj, deg, wids, R)
    if walks.device.type != "cuda":
        raise ValueError(f"walks must lie on a CUDA device, got "
                         f"{walks.device}")
    steps = torch.zeros((), dtype=torch.int64, device=walks.device)
    B = int(wids.shape[0])
    if B == 0:
        return steps
    lib = library()
    shape = _regen_shape(lib, walks, adj, B)
    code = lib.walk_regen_launch(
        walks.data_ptr(), counts.data_ptr(), adj.data_ptr(), deg.data_ptr(),
        wids.data_ptr(), B, counts.shape[0] - 1, R, walks.shape[1],
        adj.shape[1], float(alpha), int(key[0]), int(key[1]),
        steps.data_ptr(), shape.grid, shape.warps,
        torch.cuda.current_stream(walks.device).cuda_stream)
    _raise_on(lib, code, "walk_regen")
    nvcc.count_launch(walk_regen_cuda)
    return steps


walk_regen_cuda.launches = 0


def walk_regen_plain(walks, counts, adj, deg, wids, *, R: int, alpha: float,
                     key: Tuple[int, int]) -> torch.Tensor:
    """The reference's ``_regen_step`` with tensor ops, every draw taken
    (the kernel skips a dead walk's): the same rows and counts."""
    _check_regen(walks, counts, adj, deg, wids, R)
    dev = walks.device
    n, L, cap = counts.shape[0] - 1, walks.shape[1], adj.shape[1]
    nr = walks.shape[0] - 1
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, int(wids.shape[0]), PLAIN_CHUNK):
        w = wids[lo:lo + PLAIN_CHUNK].long()
        old = walks[w]
        u = threefry.uniform(threefry.fold_in(key, w), (2, L),
                             dtype=torch.float64)
        cur = torch.where(w < nr, w // R, n)
        alive = cur < n
        cols = [cur]
        for t in range(L - 1):
            d = deg[cur].long()
            j = torch.minimum((u[:, 1, t] * (d + 1).double()).long(), d)
            nxt = torch.where(j == d, cur,
                              adj[cur, j.clamp(max=cap - 1)].long())
            alive = alive & (u[:, 0, t] < alpha)
            cur = torch.where(alive, nxt, cur)
            cols.append(torch.where(alive, nxt, n))
        traj = torch.stack(cols, 1).to(torch.int32)
        one = torch.ones(traj.numel(), dtype=torch.int32, device=dev)
        counts.index_add_(0, old.clamp(max=n).reshape(-1).long(), -one)
        counts.index_add_(0, traj.reshape(-1).long(), one)
        counts[n] = 0
        walks[w] = traj
        steps += (traj < n).sum()
    return steps


def walk_regen(walks, counts, adj, deg, wids, *, R: int, alpha: float,
               key: Tuple[int, int]) -> torch.Tensor:
    """The kernel on a CUDA walk buffer, its plain version on a CPU one."""
    kw = dict(R=R, alpha=alpha, key=key)
    if walks.device.type == "cuda":
        return walk_regen_cuda(walks, counts, adj, deg, wids, **kw)
    if walks.device.type == "cpu":
        return walk_regen_plain(walks, counts, adj, deg, wids, **kw)
    raise ValueError(f"the walk kernels run on CUDA (kernel) or CPU (plain "
                     f"version); got a tensor on {walks.device}")


# ---------------------------------------------------------------------------
# walk_touch
# ---------------------------------------------------------------------------

def walk_touch_cuda(walks, touched, *, n_walks: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``(flags [n_walks] bool, mass 0-d int64)`` — which of
    the first ``n_walks`` rows visit a vertex ``touched`` marks (``touched
    [n+1]`` bool, entry n False), and the sum over rows of the distinct
    touched vertices each visits."""
    _check_touch(walks, touched, n_walks)
    if walks.device.type != "cuda":
        raise ValueError(f"walks must lie on a CUDA device, got "
                         f"{walks.device}")
    flags = torch.empty(n_walks, dtype=torch.bool, device=walks.device)
    mass = torch.zeros((), dtype=torch.int64, device=walks.device)
    lib = library()
    code = lib.walk_touch_launch(
        walks.data_ptr(), touched.data_ptr(), n_walks, walks.shape[1],
        touched.shape[0] - 1, flags.data_ptr(), mass.data_ptr(),
        torch.cuda.current_stream(walks.device).cuda_stream)
    _raise_on(lib, code, "walk_touch")
    nvcc.count_launch(walk_touch_cuda)
    return flags, mass


walk_touch_cuda.launches = 0


def walk_touch_plain(walks, touched, *, n_walks: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: sort, keep each value's first occurrence, count the touched
    ones (the sentinel n is never touched)."""
    _check_touch(walks, touched, n_walks)
    flags = torch.empty(n_walks, dtype=torch.bool, device=walks.device)
    mass = torch.zeros((), dtype=torch.int64, device=walks.device)
    for lo in range(0, n_walks, PLAIN_CHUNK):
        hi = min(lo + PLAIN_CHUNK, n_walks)
        s = walks[lo:hi].sort(dim=1).values
        first = torch.ones_like(s, dtype=torch.bool)
        first[:, 1:] = s[:, 1:] != s[:, :-1]
        cnt = (touched[s.long()] & first).sum(1)
        flags[lo:hi] = cnt > 0
        mass += cnt.sum()
    return flags, mass


def walk_touch(walks, touched, *, n_walks: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA walk buffer, its plain version on a CPU one."""
    if walks.device.type == "cuda":
        return walk_touch_cuda(walks, touched, n_walks=n_walks)
    if walks.device.type == "cpu":
        return walk_touch_plain(walks, touched, n_walks=n_walks)
    raise ValueError(f"the walk kernels run on CUDA (kernel) or CPU (plain "
                     f"version); got a tensor on {walks.device}")


# ---------------------------------------------------------------------------
# the cipher alone (a check of the device cipher; not on the walk path)
# ---------------------------------------------------------------------------

def threefry_words_cuda(k0, k1, x0, x1) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """``threefry2x32((k0, k1), x0, x1)`` elementwise on the card with the
    kernels' own device cipher.  Takes int64 tensors of 32-bit words (as
    :mod:`repro_torch.core.threefry` does) and returns two such tensors."""
    if k0.device.type != "cuda":
        raise ValueError(f"the words must lie on a CUDA device, got "
                         f"{k0.device}")
    words = [t.to(torch.int64).reshape(-1).to(torch.int32).contiguous()
             for t in (k0, k1, x0, x1)]
    m = words[0].numel()
    y0, y1 = torch.empty_like(words[0]), torch.empty_like(words[0])
    lib = library()
    code = lib.threefry_launch(*(t.data_ptr() for t in words), m,
                               y0.data_ptr(), y1.data_ptr(),
                               torch.cuda.current_stream(k0.device)
                               .cuda_stream)
    _raise_on(lib, code, "threefry")
    mask = 0xFFFFFFFF
    return (y0.to(torch.int64) & mask).reshape(k0.shape), \
        (y1.to(torch.int64) & mask).reshape(k0.shape)
