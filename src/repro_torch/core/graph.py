"""Graph substrate: host-side dynamic graph store + device snapshots.

Ports ``src/repro/core/graph.py``: ``HostGraph`` (numpy, copied) is the
mutable host store; ``GraphSnapshot`` is the padded view every engine
consumes, built on the host and holding its arrays as torch tensors on the
snapshot's device.  Self-loops are added to every vertex (paper §5.1.3),
which removes dead ends and the global teleport correction.  The snapshot
helpers the dense engine and the frontier marking share
(``contributions``, ``pull_all``, ``out_neighbor_or``, ``initial_ranks``,
``pad_ranks``) are plain PyTorch, as the reference's are plain XLA.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_torch_dtype, resolve_device

#: every device index in a snapshot is int32; builds beyond these bounds
#: must fail loudly *before* any cast can wrap
I32_MAX = np.iinfo(np.int32).max


def _check_i32(value: int, what: str) -> None:
    if value > I32_MAX:
        raise OverflowError(
            f"{what} = {value} exceeds int32 ({I32_MAX}); the device "
            "snapshot uses 32-bit indices — widen the index dtype")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class GraphSnapshot:
    """Immutable device view of one time step of a dynamic graph.

    Padded edges carry ``src == dst == n`` (the phantom vertex)."""

    n: int                       # number of real vertices
    m: int                       # number of real edges (incl. self-loops)
    block_size: int              # vertices per block ("chunk")
    n_blocks: int
    src: torch.Tensor            # [m_pad] i32, in-edges sorted by dst
    dst: torch.Tensor            # [m_pad] i32
    in_block_ptr: torch.Tensor   # [n_blocks+1] i32
    osrc: torch.Tensor           # [m_pad] i32, out-edges sorted by src
    odst: torch.Tensor           # [m_pad] i32
    out_block_ptr: torch.Tensor  # [n_blocks+1] i32
    out_deg: torch.Tensor        # [n_pad] i32 (>=1 thanks to self-loops)
    vertex_valid: torch.Tensor   # [n_pad] bool

    @property
    def n_pad(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def m_pad(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def in_edges_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the real (src, dst) in-edge arrays (self-loops
        included) — the input to the block-sparse pull-matrix builder."""
        return (self.src[:self.m].cpu().numpy().astype(np.int64),
                self.dst[:self.m].cpu().numpy().astype(np.int64))

    @functools.cached_property
    def in_ptr(self) -> torch.Tensor:
        """[n_pad+1] i32: where each vertex's in-edges start in the
        dst-sorted real edges (self-loops included), found once per snapshot
        by a binary search of the vertex starts (no scatter)."""
        bounds = torch.arange(self.n_pad + 1, dtype=self.dst.dtype,
                              device=self.device)
        return torch.searchsorted(self.dst[:self.m].contiguous(),
                                  bounds).to(torch.int32)

    @functools.cached_property
    def in_deg(self) -> torch.Tensor:
        """[n_pad] in-edge count per vertex (self-loops included): the
        segment lengths of the dst-sorted real edges."""
        return (self.in_ptr[1:] - self.in_ptr[:-1]).long()

    def block_in_edges(self) -> torch.Tensor:
        """[n_blocks] i32: in-edge count per dst-block (sweep work metric)."""
        return self.in_block_ptr[1:] - self.in_block_ptr[:-1]

    def block_out_edges(self) -> torch.Tensor:
        """[n_blocks] i32: out-edge count per src-block (expansion
        metric)."""
        return self.out_block_ptr[1:] - self.out_block_ptr[:-1]


class HostGraph:
    """Host-side dynamic directed graph with batch update support.

    Stores the edge set (without self-loops) as sorted, de-duplicated
    ``src * n + dst`` int64 keys.  ``apply_batch`` returns a new
    ``HostGraph`` — updates are functional, matching snapshot semantics.
    """

    def __init__(self, n: int, edges: np.ndarray, *, _sorted: bool = False):
        self.n = int(n)
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        edges = edges[edges[:, 0] != edges[:, 1]]
        keys = edges[:, 0] * np.int64(self.n) + edges[:, 1]
        if not _sorted:
            keys = np.unique(keys)
        self._keys = keys

    @property
    def m(self) -> int:
        """Edge count *excluding* self-loops."""
        return int(self._keys.shape[0])

    @property
    def edges(self) -> np.ndarray:
        src = self._keys // self.n
        dst = self._keys % self.n
        return np.stack([src, dst], axis=1)

    def has_edges(self, edges: np.ndarray) -> np.ndarray:
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        keys = edges[:, 0] * np.int64(self.n) + edges[:, 1]
        idx = np.searchsorted(self._keys, keys)
        idx = np.clip(idx, 0, max(self.m - 1, 0))
        if self.m == 0:
            return np.zeros(len(keys), dtype=bool)
        return self._keys[idx] == keys

    def apply_batch(self, deletions: np.ndarray, insertions: np.ndarray
                    ) -> "HostGraph":
        dels = np.asarray(deletions, dtype=np.int64).reshape(-1, 2)
        ins = np.asarray(insertions, dtype=np.int64).reshape(-1, 2)
        ins = ins[ins[:, 0] != ins[:, 1]]
        del_keys = dels[:, 0] * np.int64(self.n) + dels[:, 1]
        ins_keys = ins[:, 0] * np.int64(self.n) + ins[:, 1]
        # the keys are sorted: binary searches of the batch's keys locate
        # every deletion and insertion, so a batch costs O(b log m) plus the
        # O(m) copies of delete/insert — where the JAX package's np.isin and
        # np.unique scan and re-sort all m keys per batch
        keys = self._keys
        if len(del_keys) and len(keys):
            pos = np.searchsorted(keys, del_keys).clip(max=len(keys) - 1)
            keys = np.delete(keys, np.unique(pos[keys[pos] == del_keys]))
        if len(ins_keys):
            new = np.unique(ins_keys)
            pos = np.searchsorted(keys, new)
            present = np.zeros(len(new), bool)
            if len(keys):
                present = keys[pos.clip(max=len(keys) - 1)] == new
            keys = np.insert(keys, pos[~present], new[~present])
        g = HostGraph.__new__(HostGraph)
        g.n = self.n
        g._keys = keys
        return g

    def snapshot(self, *, block_size: int = 256,
                 edge_capacity: Optional[int] = None,
                 device="cuda") -> GraphSnapshot:
        """Build the padded snapshot on the host (self-loops added here) and
        place its arrays on ``device``."""
        dev = resolve_device(device)
        n = self.n
        n_blocks = max(1, _round_up(n, block_size) // block_size)
        n_pad = n_blocks * block_size
        _check_i32(n_pad, "padded vertex count")
        m_est = self.m + n
        m_pad_est = edge_capacity if edge_capacity is not None else (
            _round_up(max(m_est, 1), 1024) + 1024)
        _check_i32(m_pad_est, "padded edge capacity")

        k = self._keys
        loops = np.arange(n, dtype=np.int32)
        src = np.concatenate([(k // n).astype(np.int32), loops])
        dst = np.concatenate([(k % n).astype(np.int32), loops])
        m = src.shape[0]
        m_pad = edge_capacity if edge_capacity is not None else (
            _round_up(max(m, 1), 1024) + 1024)
        if m_pad < m + 1024:
            raise ValueError(
                f"edge_capacity {m_pad} < edge count {m} + 1024 tail guard")
        _check_i32(m_pad, "padded edge capacity")

        out_deg = np.bincount(src, minlength=n_pad).astype(np.int32)

        def _sorted_padded(key_arr, a, b):
            order = np.argsort(key_arr, kind="stable")
            a, b = a[order], b[order]
            pad = np.full(m_pad - m, n, dtype=np.int32)
            return (np.concatenate([a, pad]), np.concatenate([b, pad]))

        in_dst, in_src = _sorted_padded(dst, dst, src)
        o_src, o_dst = _sorted_padded(src, src, dst)

        def _block_ptr(sorted_vertex_ids: np.ndarray) -> np.ndarray:
            bounds = np.arange(n_blocks + 1, dtype=np.int64) * block_size
            return np.searchsorted(
                sorted_vertex_ids[:m], bounds, side="left").astype(np.int32)

        vv = np.zeros(n_pad, dtype=bool)
        vv[:n] = True

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return GraphSnapshot(
            n=n, m=m, block_size=block_size, n_blocks=n_blocks,
            src=t(in_src), dst=t(in_dst), in_block_ptr=t(_block_ptr(in_dst)),
            osrc=t(o_src), odst=t(o_dst), out_block_ptr=t(_block_ptr(o_src)),
            out_deg=t(out_deg), vertex_valid=t(vv))


def initial_ranks(g: GraphSnapshot, dtype=torch.float64) -> torch.Tensor:
    """Uniform 1/n over the valid vertices, 0 on the padding."""
    dt = as_torch_dtype(dtype)
    r = torch.full((g.n_pad,), 1.0 / g.n, dtype=dt, device=g.device)
    return torch.where(g.vertex_valid, r, torch.zeros((), dtype=dt,
                                                      device=g.device))


# ---------------------------------------------------------------------------
# torch-side helpers shared by the engines
# ---------------------------------------------------------------------------

def contributions(g: GraphSnapshot, ranks: torch.Tensor) -> torch.Tensor:
    """``R[u] / outdeg(u)`` padded with a trailing 0 for the phantom
    vertex."""
    deg = g.out_deg.clamp(min=1).to(ranks.dtype)
    c = torch.where(g.vertex_valid, ranks[:g.n_pad] / deg,
                    torch.zeros((), dtype=ranks.dtype, device=ranks.device))
    return torch.cat([c, c.new_zeros(1)])


def pull_all(g: GraphSnapshot, ranks: torch.Tensor, *, alpha: float,
             personalization=None) -> torch.Tensor:
    """Dense pull step over every vertex: one full SpMV.

    The sum over each vertex's in-edges is ``torch.segment_reduce`` over
    the dst-sorted real edges, one segment per vertex: a segmented sum with
    no atomics, so its result repeats bit for bit on the card (an
    ``index_add_`` there adds in an unfixed order).  ``personalization``
    (a restart distribution [n_pad], summing to 1 over valid vertices)
    replaces the uniform ``1/n`` teleport."""
    c = contributions(g, ranks)
    src = g.src[:g.m].long()
    pulled = torch.segment_reduce(c[src], "sum", lengths=g.in_deg,
                                  unsafe=True)
    dt, dev = ranks.dtype, ranks.device
    one_m_a = torch.tensor(1.0 - alpha, dtype=dt, device=dev)
    if personalization is None:
        base = one_m_a / torch.tensor(g.n, dtype=dt, device=dev)
    else:
        base = one_m_a * torch.as_tensor(personalization, dtype=dt,
                                         device=dev)[:g.n_pad]
    r = base + torch.tensor(alpha, dtype=dt, device=dev) * pulled
    return torch.where(g.vertex_valid, r, torch.zeros((), dtype=dt,
                                                      device=dev))


def out_neighbor_or(g: GraphSnapshot, flags: torch.Tensor) -> torch.Tensor:
    """OR-semiring SpMV on the transposed adjacency: the indicator of the
    vertices with at least one in-neighbour in ``flags`` (the
    out-neighbourhood of the flagged set).  A max-scatter over ``odst``:
    order-free, so exact on the card."""
    return _or_scatter(g.osrc.long(), g.odst.long(), flags, g.vertex_valid)


def _or_scatter(osrc: torch.Tensor, odst: torch.Tensor, flags: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """:func:`out_neighbor_or` over int64 copies of the padded out-edge
    arrays (callers that hop many times convert them once)."""
    n_pad = valid.shape[0]
    f = torch.cat([flags[:n_pad].to(torch.int32),
                   torch.zeros(1, dtype=torch.int32, device=flags.device)])
    hit = torch.zeros(n_pad + 1, dtype=torch.int32, device=flags.device)
    hit.scatter_reduce_(0, odst, f[osrc], reduce="amax")
    return (hit[:n_pad] > 0) & valid


def pad_ranks(g: GraphSnapshot, ranks) -> torch.Tensor:
    """Pad/crop a rank vector from another snapshot family onto this one
    (keeps the ranks' dtype; placed on the snapshot's device)."""
    ranks = torch.as_tensor(ranks, device=g.device)
    r = torch.zeros(g.n_pad, dtype=ranks.dtype, device=g.device)
    k = min(int(ranks.shape[0]), g.n_pad)
    r[:k] = ranks[:k]
    return r
