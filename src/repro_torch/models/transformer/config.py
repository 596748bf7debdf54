"""Transformer configuration (ports ``src/repro/models/transformer/config.py``;
covers all five assigned LM architectures)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    renormalize: bool = True          # Mixtral-style top-k renormalisation


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None              # default d_model // n_heads
    mlp: str = "swiglu"                       # "swiglu" | "squared_relu"
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None      # SWA width (Mixtral)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # execution
    dtype: str = "bfloat16"                   # activation dtype
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_q_chunk: int = 1024                  # q-chunked attention (mem bound)
    zero1: bool = True                        # ZeRO-1 optimizer sharding
    # pad the embedding/head vocab dim up to a multiple (restores vocab-axis
    # sharding when the raw vocab is not divisible by the mesh; §Perf knob).
    pad_vocab_to_multiple: Optional[int] = None
    # KV-cache storage dtype (None → activation dtype).  "float8_e4m3fn"
    # halves decode HBM vs bf16 — the §Perf knob that brings the 32k-context
    # decode cells under single-pod HBM.
    cache_dtype: Optional[str] = None

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab_to_multiple:
            return self.vocab
        m = self.pad_vocab_to_multiple
        return ((self.vocab + m - 1) // m) * m

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6·N·D roofline term)."""
        D, H, KV, dh, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.d_head, self.d_ff, self.vocab,
                                 self.n_layers)
        attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * dh
        if self.moe:
            ff = self.moe.n_experts * (3 if self.mlp == "swiglu" else 2) \
                * D * F + D * self.moe.n_experts
        else:
            ff = (3 if self.mlp == "swiglu" else 2) * D * F
        norms = 2 * D
        emb = V * D * (1 if self.tie_embeddings else 2)
        return L * (attn + ff + norms) + emb + D

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        per_expert = (3 if self.mlp == "swiglu" else 2) * D * F
        inactive = L * (self.moe.n_experts - self.moe.top_k) * per_expert
        return self.param_count() - inactive
