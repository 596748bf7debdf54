"""mixtral-8x22b — MoE LM, 56L d_model=6144 48H (GQA kv=8) d_ff=16384
(per-expert), vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

Sliding-window attention (window 4096) bounds the KV cache and makes
attention sub-quadratic in sequence length, so this is the one LM arch that
*runs* the ``long_500k`` cell (524,288-token decode with a ring-buffered
4096-slot cache).
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig

SLIDING_WINDOW = 4096


def build_cfg(**kw) -> TransformerConfig:
    base = dict(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab=32768, qkv_bias=False,
        mlp="swiglu", rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=8, top_k=2),
        sliding_window=SLIDING_WINDOW,
        dtype="bfloat16", param_dtype="bfloat16",
    )
    base.update(kw)
    return TransformerConfig(**base)


def smoke_cfg() -> TransformerConfig:
    return build_cfg(name="mixtral-smoke", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=64, vocab=256,
                     moe=MoEConfig(n_experts=4, top_k=2),
                     sliding_window=32, dtype="float32",
                     param_dtype="float32", attn_q_chunk=64)


register(ArchSpec(
    arch_id="mixtral-8x22b",
    family="lm",
    source="arXiv:2401.04088; hf",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=lm_shapes(
        subquadratic=True,
        long_note="runs via sliding-window attention: 4096-slot ring-buffer "
                  "KV cache keeps decode O(window) at 524k context"),
    rules_override={
        "embed": "data",         # FSDP for the 141B params
        "experts": "pod",        # expert parallelism on the multi-pod mesh
        "moe_capacity": "data",
    },
    exec_overrides={
        "train_4k": {"microbatches": 8},
    },
    notes="8-expert top-2 MoE with SWA; the only LM arch running long_500k.",
))
