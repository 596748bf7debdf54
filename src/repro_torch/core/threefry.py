"""Threefry-2x32, the counter-based generator behind ``jax.random``, in
plain PyTorch (the port keeps its own copy: it imports no JAX).

The walk engine draws every random number of a walk from
``fold_in(prng_key(seed), walk_id)``, as the reference does with
``jax.random``; this module gives the same 32-bit words and the same f32
uniforms, so the port's walks equal the reference's bit for bit.  It is the
plain version of the generator that ``kernels/walk/csrc/walk.cu`` runs in
registers.

* :func:`prng_key` — ``jax.random.PRNGKey(seed)``: ``[seed >> 32,
  seed & 0xFFFFFFFF]``;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``:
  ``threefry2x32(key, [0, uint32(data)])``;
* :func:`uniform_bits` / :func:`uniform` — ``jax.random.bits`` /
  ``jax.random.uniform(key, shape, dtype)`` under
  ``jax_threefry_partitionable=True`` (JAX's default since 0.5): element
  *i* of the flattened shape comes from ``(out0, out1) =
  threefry2x32(key, [0, i])``; a 32-bit word is ``out0 ^ out1`` and its
  f32 ``bitcast((bits >> 9) | 0x3f800000) - 1``, a 64-bit word is
  ``out0 << 32 | out1`` and its f64 ``bitcast((bits >> 12) |
  0x3ff0000000000000) - 1``.

The reference draws its walks with ``jax.random.uniform`` in JAX's default
float, which is f64 under ``jax_enable_x64`` (the repo's setting, in which
its ranks are f64 and its tests run); the walk engine uses the f64 draws.

uint32 arithmetic is done in int64 with a mask.  A key is a pair of
integers or of int64 tensors (one key per element, broadcast against the
counters).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 with 20 rounds of ``key`` on the counter words
    ``(x0, x1)``: the block function of ``jax.random``'s threefry."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**64)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed={seed} outside [0, 2**64)")
    return seed >> 32, seed & MASK


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` may be a tensor of ids
    (one key each)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
        zero = torch.zeros_like(data)
    else:
        data, zero = int(data) & MASK, 0
    return threefry2x32(key, zero, data)


def _as_column(word: Word) -> Word:
    return word.reshape(-1, 1) if isinstance(word, torch.Tensor) else word


def _words(key: Key, shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """``threefry2x32(key, [0, i])`` for every flat index i of ``shape``:
    the partitionable counter layout, ``[B, *shape]`` for B keys."""
    k0, k1 = key
    if device is None:
        device = k0.device if isinstance(k0, torch.Tensor) else "cpu"
    size = 1
    for s in shape:
        size *= int(s)
    ctr = torch.arange(size, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32((_as_column(k0), _as_column(k1)),
                          torch.zeros_like(ctr), ctr)
    lead = tuple(k0.shape) if isinstance(k0, torch.Tensor) else ()
    return y0.reshape(*lead, *shape), y1.reshape(*lead, *shape)


def uniform_bits(key: Key, shape: Sequence[int], *,
                 device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` in the partitionable layout:
    the words ``out0 ^ out1`` as int64 in [0, 2**32)."""
    y0, y1 = _words(key, shape, device)
    return y0 ^ y1


def uniform(key: Key, shape: Sequence[int], *, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1): the top
    mantissa bits of the words as a float in [1, 2), minus 1 — f32 from
    the 32-bit words (``bits >> 9``), f64 from the 64-bit ones
    (``bits >> 12``).  Under ``jax_enable_x64`` the reference's default
    dtype, and so its walks' draws, are f64."""
    if dtype == torch.float32:
        f = (uniform_bits(key, shape, device=device) >> 9) | 0x3F800000
        return f.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        y0, y1 = _words(key, shape, device)
        mant = (y0 << 20) | (y1 >> 12)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    raise ValueError(f"dtype={dtype}: torch.float32 or torch.float64")
