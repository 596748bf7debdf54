"""phi4-mini-3.8b — dense LM, 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA.  [arXiv:2412.08905; hf]

Embeddings are tied (phi-mini family practice), which is also what lands the
total at ~3.8B; untied would be ~4.4B.
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import TransformerConfig


def build_cfg(**kw) -> TransformerConfig:
    base = dict(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=200064, qkv_bias=False,
        mlp="swiglu", rope_theta=10_000.0, tie_embeddings=True,
        dtype="bfloat16", param_dtype="float32",
    )
    base.update(kw)
    return TransformerConfig(**base)


def smoke_cfg() -> TransformerConfig:
    return build_cfg(name="phi4-mini-smoke", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                     dtype="float32", attn_q_chunk=64)


register(ArchSpec(
    arch_id="phi4-mini-3.8b",
    family="lm",
    source="arXiv:2412.08905; hf",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=lm_shapes(subquadratic=False),
    exec_overrides={
        "train_4k": {"microbatches": 4},
    },
    notes="GQA 24q/8kv, tied embeddings; full attention ⇒ long_500k skipped.",
))
