"""The LM transformer family (ports ``src/repro/models/transformer``):
``config`` (``TransformerConfig``, ``MoEConfig``), ``layers`` (RMSNorm,
RoPE, GQA attention, MLPs, MoE) and ``model`` (init, forward, loss,
prefill, decode).  The continuous-batching decode
(``decode_attention_batch``, ``decode_batch_step``) comes with the serve
engine and ``abstract_params`` with the launch analytics (ROADMAP A 15b)."""
from repro_torch.models.transformer.config import MoEConfig, TransformerConfig
from repro_torch.models.transformer import layers, model

__all__ = ["MoEConfig", "TransformerConfig", "layers", "model"]
