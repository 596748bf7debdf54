"""Dynamic Frontier helpers of the fused driver (ports the stream-mode part
of ``src/repro/core/frontier.py``: ``pack_batch``, ``block_any``,
``compact_block_ids``).

All marking is an idempotent OR; the helpers here never synchronise with
the host, so a sweep built from them runs without a device-to-host read.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def pack_batch(n_pad: int, deletions: np.ndarray, insertions: np.ndarray,
               *, bucket: int = 1024, device="cuda") -> torch.Tensor:
    """Pack a batch update into a padded [b_pad, 2] int32 tensor on
    ``device``.  Padded rows use the phantom vertex ``n_pad`` as source."""
    b = np.concatenate([np.asarray(deletions, np.int64).reshape(-1, 2),
                        np.asarray(insertions, np.int64).reshape(-1, 2)], 0)
    b_pad = max(bucket, ((len(b) + bucket - 1) // bucket) * bucket)
    out = np.full((b_pad, 2), n_pad, dtype=np.int32)
    if len(b):
        out[:len(b)] = b
    return torch.from_numpy(out).to(resolve_device(device))


def block_any(flags: torch.Tensor, n_blocks: int, block_size: int
              ) -> torch.Tensor:
    """Per-block OR over a [n_pad] vertex indicator → [n_blocks] bool."""
    return flags[:n_blocks * block_size].reshape(n_blocks,
                                                 block_size).any(dim=1)


def compact_block_ids(act: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Compacted active-block slot list: active ids first (ascending), then
    −1 padding — a fixed ``[n_blocks]`` int32 buffer.

    A prefix sum gives every active block its slot and one scatter writes
    it; inactive blocks scatter into a trash slot past the end.  Unlike
    ``torch.nonzero`` this has a static output shape and never waits for
    the device."""
    pos = torch.cumsum(act, dim=0) - 1
    dst = torch.where(act, pos, n_blocks)
    out = torch.full((n_blocks + 1,), -1, dtype=torch.int32,
                     device=act.device)
    out.scatter_(0, dst, torch.arange(n_blocks, dtype=torch.int32,
                                      device=act.device))
    return out[:n_blocks]
