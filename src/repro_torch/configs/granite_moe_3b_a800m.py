"""granite-moe-3b-a800m — MoE LM, 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per-expert), vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; hf]

Note: the assignment line reads "MoE 40e top-8" with an annotation "32
experts top-8"; we follow the primary spec (40 experts, top-8).  Total
params ≈ 3.4B, active ≈ 0.9B — matching the 3b-a800m name.

vocab = 49155 is not divisible by any mesh-axis size, so the vocab axis is
*unsharded* in the baseline (logical_to_spec drops non-divisible
assignments).  The §Perf log shows the padded-vocab variant
(``pad_vocab_to_multiple``) that restores vocab sharding.
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig


def build_cfg(**kw) -> TransformerConfig:
    base = dict(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, d_ff=512, vocab=49155, qkv_bias=False,
        mlp="swiglu", rope_theta=10_000.0,
        moe=MoEConfig(n_experts=40, top_k=8),
        dtype="bfloat16", param_dtype="float32",
    )
    base.update(kw)
    return TransformerConfig(**base)


def smoke_cfg() -> TransformerConfig:
    return build_cfg(name="granite-moe-smoke", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=255,
                     moe=MoEConfig(n_experts=4, top_k=2),
                     dtype="float32", attn_q_chunk=64)


register(ArchSpec(
    arch_id="granite-moe-3b-a800m",
    family="lm",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled); hf",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=lm_shapes(subquadratic=False),
    rules_override={
        "experts": "pod",        # expert parallelism on the multi-pod mesh
        "moe_capacity": "data",  # dispatch buffers shard their token dim
    },
    exec_overrides={
        "train_4k": {"microbatches": 4},
    },
    notes="40-expert top-8 MoE; full attention ⇒ long_500k skipped.",
))
