"""Transformer building blocks (ports
``src/repro/models/transformer/layers.py``): RMSNorm, RoPE, GQA attention
(q-chunked causal / sliding-window, single position decode), dense MLPs,
and capacity-based MoE.

Plain PyTorch, with the reference's precision: where the reference asks for
f32 results from low-precision inputs (``preferred_element_type``: the
attention scores), the operands are upcast to f32 (exact) and multiplied in
IEEE f32 (TF32 stays off); masks use the finite ``NEG_INF``, not
``scaled_dot_product_attention``'s ``-inf``.  ``constrain`` (the reference's
sharding constraints) is the identity on one device and is not called.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.transformer.config import TransformerConfig

NEG_INF = -1e9
F8 = torch.float8_e4m3fn
# the largest finite float8_e4m3fn is 448; anything above the midpoint to the
# next step (480, the NaN encoding) rounds to NaN in the reference's cast
F8_OVERFLOW = 464.0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=dtype,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, dh]; positions: [..., S] (broadcastable).  Rotates the
    two halves of the head dim (not interleaved pairs), in f32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs        # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def cache_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the KV cache's dtype.  For ``float8_e4m3fn`` this is the
    reference's cast (XLA's, as ``ml_dtypes``): round to nearest even, and a
    NaN with ``t``'s sign where ``|t| > 464`` or ``t`` is NaN or infinite —
    torch's own cast saturates to ±448 there."""
    out = t.to(dtype)
    if dtype != F8:
        return out
    bad = (t.abs() > F8_OVERFLOW) | torch.isnan(t)
    nan = torch.where(torch.signbit(t), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(bad, nan, out.view(torch.uint8)).view(F8)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,d...->......") over x's last axis and w's first."""
    out = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def _qkv(x, p, cfg: TransformerConfig, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scaled(q: torch.Tensor, dh: int) -> torch.Tensor:
    """q · dh^-½ with the scale in q's dtype, as the reference's weakly
    typed scalar is."""
    return q * torch.tensor(dh ** -0.5, dtype=q.dtype, device=q.device)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """einsum("bqkrd,bskd->bkrqs") with an f32 result: q [B, Q, KV, rep,
    dh], k [B, S, KV, dh] → [B, KV, rep, Q, S]."""
    B, Q, KV, rep, dh = q.shape
    qm = q.float().permute(0, 2, 3, 1, 4).reshape(B, KV, rep * Q, dh)
    s = qm @ k.float().permute(0, 2, 3, 1)
    return s.view(B, KV, rep, Q, k.shape[1])


def _attend(pattn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bkrqs,bskd->bqkrd"): pattn [B, KV, rep, Q, S], v [B, S, KV,
    dh] → [B, Q, KV, rep, dh]."""
    B, KV, rep, Q, S = pattn.shape
    o = pattn.reshape(B, KV, rep * Q, S) @ v.permute(0, 2, 1, 3)
    return o.view(B, KV, rep, Q, -1).permute(0, 3, 1, 2, 4)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]).to(o.dtype)


def q_chunk(cfg: TransformerConfig, S: int) -> int:
    """The largest divisor of S that is ≤ ``attn_q_chunk``."""
    cq = min(cfg.attn_q_chunk, S)
    while S % cq:
        cq -= 1
    return cq


def causal_attention(x, p, cfg: TransformerConfig, positions) -> torch.Tensor:
    return causal_attention_with_kv(x, p, cfg, positions)[0]


def causal_attention_with_kv(x, p, cfg: TransformerConfig, positions
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Full-sequence GQA attention, q-chunked for O(chunk·S) score memory,
    with causal and optional sliding-window masking.  Also returns the
    (roped) K/V for prefill cache construction."""
    B, S, _ = x.shape
    KV, rep, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head
    q, k, v = _qkv(x, p, cfg, positions)
    q = _scaled(q.reshape(B, S, KV, rep, dh), dh)
    cq = q_chunk(cfg, S)
    kv_pos = positions if positions.dim() > 1 else positions[None, :]
    chunks = []
    for lo in range(0, S, cq):
        qp = kv_pos[:, lo:lo + cq]
        s = _scores(q[:, lo:lo + cq], k)
        mask = qp[:, :, None] >= kv_pos[:, None, :]            # causal
        if cfg.sliding_window:
            mask &= (qp[:, :, None] - kv_pos[:, None, :]) < cfg.sliding_window
        s.masked_fill_(~mask[:, None, None], NEG_INF)
        pattn = torch.softmax(s, dim=-1).to(x.dtype)
        del s
        chunks.append(_attend(pattn, v))
    out = torch.cat(chunks, dim=1) if len(chunks) > 1 else chunks[0]
    return _out_proj(out.reshape(B, S, cfg.n_heads, dh), p["wo"]), k, v


def decode_attention(x, p, cfg: TransformerConfig, cache_k, cache_v,
                     position) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Single-token decode with a (possibly ring-buffered SWA) KV cache.

    x: [B, 1, D]; cache_k/v: [B, S_cache, KV, dh]; position: the current
    absolute position (an int).  Writes the position's K/V into
    ``cache_k``/``cache_v`` in place — at slot ``position % S_cache`` with
    a sliding window, else at ``position`` clamped into the cache as the
    reference's ``dynamic_update_slice`` clamps — and returns (out,
    cache_k, cache_v).  The reference returns new arrays; ``decode_step``
    copies the caller's cache once, so its result is the reference's.
    """
    B = x.shape[0]
    KV, rep, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head
    S_cache = cache_k.shape[1]
    position = int(position)
    pos_arr = torch.full((1, 1), position, dtype=torch.int32,
                         device=x.device)
    q, k, v = _qkv(x, p, cfg, pos_arr)
    slot = position % S_cache if cfg.sliding_window else position
    slot = min(max(slot, 0), S_cache - 1)
    cache_k[:, slot] = cache_cast(k[:, 0], cache_k.dtype)
    cache_v[:, slot] = cache_cast(v[:, 0], cache_v.dtype)

    q = _scaled(q.reshape(B, 1, KV, rep, dh), dh)
    s = _scores(q, cache_k.to(x.dtype))
    n_valid = min(position + 1, S_cache) if cfg.sliding_window \
        else position + 1
    s[..., n_valid:] = NEG_INF
    pattn = torch.softmax(s, dim=-1).to(x.dtype)
    out = _attend(pattn, cache_v.to(x.dtype))
    out = _out_proj(out.reshape(B, 1, cfg.n_heads, dh), p["wo"])
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x), two roundings in x's dtype, as ``jax.nn.silu``."""
    return x * torch.sigmoid(x)


def dense_mlp(x, p, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = _silu(_proj(x, p["wi_gate"])) * _proj(x, p["wi_up"])
    elif cfg.mlp == "squared_relu":
        h = torch.relu(_proj(x, p["wi"])).square()
    else:
        raise ValueError(cfg.mlp)
    return _proj(h, p["wo_mlp"])


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties broken toward
    the lower index (a stable descending sort; ``torch.topk`` promises no
    tie order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(x, p, cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE (GShard-style, scatter dispatch).
    Returns (output, aux_load_balancing_loss).

    Capacity positions come from a cumsum over the flat token-major
    ``[T*K]`` choices, so kept slots are unique per (expert, slot) and the
    dispatch is a plain write; only the discarded drop bin ``E`` collides.
    No float result depends on a write order."""
    mcfg = cfg.moe
    B, S, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    router_logits = xt.float() @ p["router"].float()
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                   # [T, K]
    if mcfg.renormalize:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Switch-style aux loss: E · Σ_e fraction_tokens(e) · mean_prob(e)
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()

    flat_e = gate_idx.reshape(-1)                           # [T*K]
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    del onehot
    capacity = max(1, int(mcfg.capacity_factor * T * K / E))
    keep = pos < capacity
    slot_e = torch.where(keep, flat_e, E)                   # drop bin E
    slot_c = pos.clamp(0, capacity - 1)

    buf = torch.zeros((E + 1, capacity, D), dtype=x.dtype, device=x.device)
    buf[slot_e, slot_c] = xt.repeat_interleave(K, dim=0)
    buf = buf[:E]

    if cfg.mlp == "swiglu":
        h = torch.bmm(buf, p["we_gate"].to(x.dtype))
        h.mul_(torch.sigmoid(h))
        h.mul_(torch.bmm(buf, p["we_up"].to(x.dtype)))
    else:
        h = torch.relu(torch.bmm(buf, p["we_up"].to(x.dtype))).square()
    del buf
    out_buf = torch.bmm(h, p["we_down"].to(x.dtype))
    del h
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, capacity, D))], 0)

    y = out_buf[slot_e, slot_c]                             # [T*K, D]
    y = y * (keep * gate_vals.reshape(-1)).to(x.dtype)[:, None]
    y = y.reshape(T, K, D).sum(dim=1)
    return y.reshape(B, S, D), aux
