"""Device and dtype rules of the port (no counterpart in ``src/repro``).

Every entry point of :mod:`repro_torch` that places state takes ``device=``
with the default ``"cuda"``.  With no CUDA device the default raises: the
port never carries on on the CPU unless the caller asked for it by passing
``device="cpu"`` explicitly (the CPU tests do).
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}     # the LM KV cache


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """The torch device for ``device``; raises when it names CUDA and no
    CUDA device is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible: the port "
            "runs on the card and never falls back to the CPU on its own — "
            "pass device='cpu' explicitly to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={str(device)!r}: the port runs on 'cuda' "
                         "or, when asked, 'cpu'")
    return dev


def as_torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"dtype {dtype!r} unsupported; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]
