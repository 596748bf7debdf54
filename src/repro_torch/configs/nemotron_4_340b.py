"""nemotron-4-340b — dense LM, 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819; unverified]

At 340B parameters this is the memory-limit architecture of the assignment:
  * params/grads/optimizer state in bf16 (f32 Adam state alone would be
    21 GB/chip on the single-pod mesh — over the 16 GB v5e HBM);
  * FSDP: the d_model ("embed") param axis shards over "data" in addition to
    the usual tensor-parallel axes, giving full 256/512-way param sharding;
  * sequence parallelism: residual-stream activations shard their seq axis
    over "model" between layers, cutting remat carries 16×;
  * 8 gradient-accumulation microbatches.
All four choices are recorded as hardware-adaptation deltas in DESIGN.md.
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer.config import TransformerConfig


def build_cfg(**kw) -> TransformerConfig:
    base = dict(
        name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, d_ff=73728, vocab=256000, qkv_bias=False,
        mlp="squared_relu", rope_theta=10_000.0,
        dtype="bfloat16", param_dtype="bfloat16",
    )
    base.update(kw)
    return TransformerConfig(**base)


def smoke_cfg() -> TransformerConfig:
    return build_cfg(name="nemotron-smoke", n_layers=2, d_model=64,
                     n_heads=8, n_kv_heads=2, d_ff=256, vocab=256,
                     dtype="float32", param_dtype="float32",
                     attn_q_chunk=64)


register(ArchSpec(
    arch_id="nemotron-4-340b",
    family="lm",
    source="arXiv:2402.16819; unverified",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=lm_shapes(subquadratic=False),
    rules_override={
        "embed": "data",        # FSDP / ZeRO-3-style param sharding
        "seq": "model",         # sequence-parallel residual stream
    },
    exec_overrides={
        "train_4k": {"microbatches": 8, "state_dtype": "bfloat16",
                     "accum_dtype": "bfloat16"},
    },
    notes="squared-ReLU GQA; bf16 states + FSDP + SP to fit 16 GB/chip; "
          "full attention ⇒ long_500k skipped.",
))
