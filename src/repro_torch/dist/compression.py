"""Wire-compression primitives (ports ``src/repro/dist/compression.py``):
the bf16 cast, top-k sparsification with error feedback, and symmetric
8-bit quantization.

The reference maps them over JAX pytrees; here a "tree" is a tensor or a
dict, list or tuple of trees, mapped by :func:`tree_map`.  They are exact
in their accounting: what a round does not send stays in the
error-feedback residual and resurfaces in the next round.  The top-k
threshold comes from ``torch.topk`` where the reference uses
``lax.top_k``; both give the k-th largest magnitude."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (and the same places of
    ``rest``), keeping the dict / list / tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# -- bf16 wire cast ----------------------------------------------------------

def bf16_compress(grads: Any) -> Any:
    """Cast every tensor to bfloat16 (half the wire bytes of f32)."""
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def bf16_decompress(compressed: Any, like: Any) -> Any:
    """Cast back to the dtypes of ``like`` (the f32 master copy)."""
    return tree_map(lambda c, g: c.to(g.dtype), compressed, like)


# -- top-k with error feedback ----------------------------------------------

@dataclasses.dataclass
class ErrorFeedback:
    """Per-tensor residual of the mass not sent yet."""
    residual: Any

    @classmethod
    def init(cls, grads: Any) -> "ErrorFeedback":
        return cls(residual=tree_map(torch.zeros_like, grads))


def _topk_one(g: torch.Tensor, r: torch.Tensor, frac: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    acc = g + r
    flat = acc.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(acc.abs() >= thresh, acc, torch.zeros_like(acc))
    return kept, acc - kept


def topk_compress(grads: Any, ef: ErrorFeedback, *, frac: float
                  ) -> Tuple[Any, ErrorFeedback]:
    """Keep the top ``frac`` fraction (by magnitude) of ``grads + residual``
    per tensor; the rest becomes the next residual.  Conserves mass
    exactly: ``kept + new_residual == grads + old_residual``."""
    pairs = tree_map(lambda g, r: _topk_one(g, r, frac), grads, ef.residual)
    is_pair = (lambda x: isinstance(x, tuple) and len(x) == 2
               and all(isinstance(t, torch.Tensor) for t in x))

    def pick(tree, i):
        if is_pair(tree):
            return tree[i]
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return type(tree)(pick(v, i) for v in tree)

    return pick(pairs, 0), ErrorFeedback(residual=pick(pairs, 1))


# -- symmetric 8-bit quantization --------------------------------------------

def quantize_8bit(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to int8: ``(q, scale)`` with
    ``g ≈ q · scale`` and |error| ≤ scale/2."""
    scale = torch.clamp(g.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_8bit(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
