"""qwen1.5-4b — dense LM, 40L d_model=2560 20H (GQA kv=20 ⇒ effectively MHA)
d_ff=6912 vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import TransformerConfig


def build_cfg(**kw) -> TransformerConfig:
    base = dict(
        name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20,
        n_kv_heads=20, d_ff=6912, vocab=151936, qkv_bias=True,
        mlp="swiglu", rope_theta=10_000.0,
        dtype="bfloat16", param_dtype="float32",
    )
    base.update(kw)
    return TransformerConfig(**base)


def smoke_cfg() -> TransformerConfig:
    return build_cfg(name="qwen1.5-4b-smoke", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                     dtype="float32", attn_q_chunk=64)


register(ArchSpec(
    arch_id="qwen1.5-4b",
    family="lm",
    source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment); hf",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=lm_shapes(subquadratic=False),
    exec_overrides={
        "train_4k": {"microbatches": 4},
    },
    notes="QKV-bias MHA (kv == heads); full attention ⇒ long_500k skipped.",
))
