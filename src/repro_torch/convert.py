"""Carry state from the JAX package into the port (no counterpart in
``src/repro``).

Every function takes plain numpy arrays — the form any JAX array turns into
with ``np.asarray`` — so a port object can start from exactly the state a
JAX object holds without this package importing JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.api.config import EngineConfig
from repro_torch.api.session import PageRankSession
from repro_torch.core.graph import HostGraph
from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.kernels.block_spmv import ops


def block_sparse_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray,
                            tile_idx: np.ndarray, n_rows: int, n_cols: int,
                            block: int, device="cuda") -> ops.BlockSparse:
    """A port ``BlockSparse`` holding the given tile pool and slot tables
    (e.g. the arrays of a ``repro.kernels.block_spmv.ops.BlockSparse``)."""
    dev = resolve_device(device)
    tile_cols = np.asarray(tile_cols, np.int32)
    if tile_cols.ndim != 2:
        raise ValueError(f"tile_cols must be [n_rb, max_tiles], got shape "
                         f"{tile_cols.shape}")
    tiles_t = torch.from_numpy(np.array(tiles)).to(dev)     # owned copy
    return ops._from_tables(int(n_rows), int(n_cols), int(block),
                            int(tile_cols.shape[1]), tiles_t, tile_cols,
                            np.asarray(tile_idx, np.int32))


def session_from_numpy(n: int, edges: np.ndarray, ranks: np.ndarray,
                       config: Optional[EngineConfig] = None,
                       device="cuda",
                       residual: Optional[np.ndarray] = None
                       ) -> PageRankSession:
    """A port session over the graph ``(n, edges)`` (self-loops excluded,
    as ``HostGraph.edges``) serving ``ranks`` (length n or n_pad) — the
    state of a JAX ``PageRankSession`` (``hg.n``, ``hg.edges``,
    ``np.asarray(sess.R)``).  For a push session, ``residual`` (the JAX
    session's ``np.asarray(sess._residual)``) is carried over exactly;
    without it the residual is rebuilt from the ranks."""
    sess = PageRankSession.from_graph(
        HostGraph(n, np.asarray(edges, np.int64)), config=config,
        r0=np.asarray(ranks), device=device)
    if residual is not None:
        if not sess._push:
            raise ValueError("residual= is the state of a driver='push' "
                             "session; the config's driver is "
                             f"{sess.config.driver!r}")
        r = torch.zeros(sess.n_pad, dtype=sess._dtype)
        res = torch.from_numpy(np.array(residual)).to(sess._dtype)
        r[:res.shape[0]] = res[:sess.n_pad]
        sess._residual = r.to(sess.device)
    return sess


def _params_from_numpy(params: Mapping[str, np.ndarray], device, dtype
                       ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = None if dtype is None else as_torch_dtype(dtype)
    out = {}
    for name, a in params.items():
        a = np.array(a)                              # owned copy
        if a.dtype.name == "bfloat16":               # ml_dtypes: the bits
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device=dev, dtype=dt if dt is not None else t.dtype)
    return out


def gnn_params_from_numpy(params: Mapping[str, np.ndarray], *,
                          device="cuda", dtype=None
                          ) -> Dict[str, torch.Tensor]:
    """The port's GNN parameter dict from the JAX package's flat one
    (``name -> array``, e.g. ``{k: np.asarray(v) for k, v in
    repro.models.gnn.graphsage.init(cfg, key).items()}``): same names, same
    values, stacked ``layers/*`` leaves keeping their leading layer axis;
    ``dtype`` casts every leaf (default: each array's own)."""
    return _params_from_numpy(params, device, dtype)


def lm_params_from_numpy(params: Mapping[str, np.ndarray], *,
                         device="cuda", dtype=None
                         ) -> Dict[str, torch.Tensor]:
    """The port's LM parameter dict from the JAX package's flat one
    (``{k: np.asarray(v) for k, v in
    repro.models.transformer.model.init_params(cfg, key).items()}``), as
    :func:`gnn_params_from_numpy`; bfloat16 arrays cross bit for bit."""
    return _params_from_numpy(params, device, dtype)
