"""Edge-list oracle for the block-sparse SpMV (ports
``src/repro/kernels/block_spmv/ref.py``)."""
from __future__ import annotations

import numpy as np
import torch


def spmv_ref(rows: np.ndarray, cols: np.ndarray, n_rows: int,
             x: torch.Tensor, *, values=None, semiring: str = "sum"
             ) -> torch.Tensor:
    """Edge-list oracle: y[r] = Σ_{k: rows[k]=r} values[k] · x[cols[k]]
    (``or``: 1 where that sum is positive)."""
    r = torch.as_tensor(np.asarray(rows, np.int64), device=x.device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=x.device)
    v = (torch.ones(r.shape, dtype=x.dtype, device=x.device) if values is None
         else torch.as_tensor(np.asarray(values), device=x.device).to(x.dtype))
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    y.index_add_(0, r, v * x[c])
    if semiring == "or":
        y = (y > 0).to(x.dtype)
    return y
