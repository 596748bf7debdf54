"""Full LM transformer (ports ``src/repro/models/transformer/model.py``):
param init, the forward over stacked layers, prefill / decode serve paths,
and the loss.  Covers all five assigned LM archs (dense GQA, QKV-bias,
squared-ReLU, capacity MoE, sliding-window attention).

Params are a flat dict; per-layer tensors are stacked on a leading "layers"
dim, and the forward is a loop over it (the reference's ``lax.scan``; the
config's ``scan_layers`` and ``remat`` choose the reference's lowering and
change nothing in a forward pass).  ``param_logical`` keeps the reference's
logical axes for the sharding rules to come.  Entry points that place
state take ``device=`` (default ``"cuda"``); the others run where their
inputs are.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.device import as_torch_dtype, resolve_device
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer.config import TransformerConfig

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    s: Dict[str, Tuple[int, ...]] = {
        "attn_norm": (D,), "mlp_norm": (D,),
        "wq": (D, H, dh), "wk": (D, KV, dh), "wv": (D, KV, dh),
        "wo": (H, dh, D),
    }
    if cfg.qkv_bias:
        s.update(bq=(H, dh), bk=(KV, dh), bv=(KV, dh))
    if cfg.moe:
        E = cfg.moe.n_experts
        s.update(router=(D, E), we_gate=(E, D, F), we_up=(E, D, F),
                 we_down=(E, F, D))
        if cfg.mlp != "swiglu":
            s.pop("we_gate")
    elif cfg.mlp == "swiglu":
        s.update(wi_gate=(D, F), wi_up=(D, F), wo_mlp=(F, D))
    else:
        s.update(wi=(D, F), wo_mlp=(F, D))
    return s


_LOGICAL = {
    "attn_norm": ("embed",), "mlp_norm": ("embed",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "wi_gate": ("embed", "ff"), "wi_up": ("embed", "ff"),
    "wi": ("embed", "ff"), "wo_mlp": ("ff", "embed"),
    "router": ("embed", "experts"),
    "we_gate": ("experts", "embed", "expert_ff"),
    "we_up": ("experts", "embed", "expert_ff"),
    "we_down": ("experts", "expert_ff", "embed"),
    "emb": ("vocab", "embed"), "final_norm": ("embed",),
    "head": ("embed", "vocab"),
}


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat {name: shape}; per-layer tensors carry the leading L dim."""
    shapes = {f"layers/{k}": (cfg.n_layers,) + v
              for k, v in _layer_shapes(cfg).items()}
    shapes["emb"] = (cfg.vocab_padded, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def param_logical(cfg: TransformerConfig) -> Dict[str, Tuple]:
    out = {}
    for name in param_shapes(cfg):
        base = name.split("/")[-1]
        lg = _LOGICAL[base]
        out[name] = (("layers",) + lg) if name.startswith("layers/") else lg
    return out


def init_params(cfg: TransformerConfig, key: Union[int, torch.Generator], *,
                device="cuda") -> Params:
    """The reference's rules in sorted name order: ones for norms, zeros
    for ``b*``, normal · fan_in^-½ otherwise, in ``cfg.param_dtype``.  The
    draws come from ``key`` — a ``torch.Generator``, or a seed for one on
    ``device`` — so they are made where the params live (the values depend
    on the generator's device; they are not ``jax.random``'s)."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(cfg.param_dtype)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    params: Params = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        base = name.split("/")[-1]
        if "norm" in base:
            params[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif base.startswith("b"):
            params[name] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            t = torch.randn(shape, generator=gen, dtype=dtype,
                            device=gen.device)
            params[name] = (t * (fan_in ** -0.5)).to(dev)
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _split_layers(params: Params) -> Tuple[Params, Params]:
    stack = {k.split("/", 1)[1]: v for k, v in params.items()
             if k.startswith("layers/")}
    top = {k: v for k, v in params.items() if not k.startswith("layers/")}
    return stack, top


def _layer_params(stack: Params, i: int) -> Params:
    return {k: v[i] for k, v in stack.items()}


def _layer(x, p, cfg: TransformerConfig, positions):
    h = L.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + L.causal_attention(h, p, cfg, positions)
    h = L.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.moe:
        y, aux = L.moe_mlp(h, p, cfg)
    else:
        y = L.dense_mlp(h, p, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _embed(top: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """``emb.astype(dtype)[tokens]``, gathered before the cast."""
    return top["emb"][tokens.long()].to(dtype)


# vocab columns per product of the head: bounds the f32 copy of the head
HEAD_CHUNK = 32768


def _logits(x: torch.Tensor, top: Params, cfg: TransformerConfig, dtype
            ) -> torch.Tensor:
    """einsum("bsd,dv->bsv", x, head.astype(dtype)) with an f32 result: the
    head rounded to the activation dtype, both operands upcast to f32
    (exact), an IEEE f32 product, in vocab chunks."""
    head = top["emb"].T if cfg.tie_embeddings else top["head"]
    x32 = x.float()
    V = head.shape[1]
    out = torch.empty(tuple(x.shape[:-1]) + (V,), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, V, HEAD_CHUNK):
        hi = min(lo + HEAD_CHUNK, V)
        out[..., lo:hi] = x32 @ head[:, lo:hi].to(dtype).float()
    return out


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int → (logits [B, S, V] f32, aux_loss scalar)."""
    stack, top = _split_layers(params)
    dtype = as_torch_dtype(cfg.dtype)
    x = _embed(top, tokens, dtype)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = _layer(x, _layer_params(stack, i), cfg, positions)
        aux = aux + a
    x = L.rmsnorm(x, top["final_norm"], cfg.norm_eps)
    return _logits(x, top, cfg, dtype), aux


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig, *, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy; labels < 0 are masked out, padded vocab
    ids get −1e9 (forward only; the backward comes with the trainer)."""
    logits, aux = forward(params, tokens, cfg)
    if cfg.vocab_padded != cfg.vocab:
        logits[..., cfg.vocab:] = -1e9
    valid = labels >= 0
    mask = valid.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    ll = torch.where(valid, ll, torch.zeros((), dtype=ll.dtype,
                                            device=ll.device))
    nll = (lse - ll) * mask
    denom = mask.sum().clamp(min=1.0)
    loss = nll.sum() / denom
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with stacked KV cache
# ---------------------------------------------------------------------------

def cache_shapes(cfg: TransformerConfig, batch: int, cache_len: int
                 ) -> Dict[str, Tuple[int, ...]]:
    eff = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shp = (cfg.n_layers, batch, eff, cfg.n_kv_heads, cfg.d_head)
    return {"k": shp, "v": shp}


def cache_logical() -> Dict[str, Tuple]:
    lg = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": lg, "v": lg}


def init_cache(cfg: TransformerConfig, batch: int, cache_len: int,
               dtype=None, *, device="cuda") -> Dict[str, torch.Tensor]:
    dtype = as_torch_dtype(dtype or cfg.cache_dtype or cfg.dtype)
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dtype, device=dev)
            for k, s in cache_shapes(cfg, batch, cache_len).items()}


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the full prompt, return (last-token logits [B, V], filled cache).

    The cache is filled up to S (ring-buffered to the window for SWA: the
    last ``eff`` positions, rolled so that absolute position p lives at slot
    p % eff) and sized ``cache_len`` so decode can continue in place.
    """
    stack, top = _split_layers(params)
    dtype = as_torch_dtype(cfg.dtype)
    B, S = tokens.shape
    x = _embed(top, tokens, dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, cache_len, device=x.device)
    eff = cache["k"].shape[2]
    for i in range(cfg.n_layers):
        lp = _layer_params(stack, i)
        h = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        attn, k, v = L.causal_attention_with_kv(h, lp, cfg, positions)
        x = x + attn
        h = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        y = L.moe_mlp(h, lp, cfg)[0] if cfg.moe else L.dense_mlp(h, lp, cfg)
        x = x + y
        for name, t in (("k", k), ("v", v)):
            t = L.cache_cast(t, cache[name].dtype)
            if eff >= S:
                cache[name][i, :, :S] = t
            else:
                cache[name][i] = torch.roll(t[:, S - eff:], S % eff, dims=1)
    x = L.rmsnorm(x[:, -1:], top["final_norm"], cfg.norm_eps)
    return _logits(x, top, cfg, dtype)[:, 0], cache


def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, position, cfg: TransformerConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: token [B] int, position the absolute position (an
    int).  Returns (logits [B, V], updated cache); ``cache`` itself is left
    as it was."""
    stack, top = _split_layers(params)
    dtype = as_torch_dtype(cfg.dtype)
    x = _embed(top, token, dtype)[:, None, :]              # [B, 1, D]
    ck, cv = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.n_layers):
        lp = _layer_params(stack, i)
        h = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        attn, _, _ = L.decode_attention(h, lp, cfg, ck[i], cv[i], position)
        x = x + attn
        h = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        y = L.moe_mlp(h, lp, cfg)[0] if cfg.moe else L.dense_mlp(h, lp, cfg)
        x = x + y
    x = L.rmsnorm(x, top["final_norm"], cfg.norm_eps)
    return _logits(x, top, cfg, dtype)[:, 0], {"k": ck, "v": cv}
