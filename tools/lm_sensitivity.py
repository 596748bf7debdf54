#!/usr/bin/env python3
"""How far rounding moves an LM's logits at random init, on the CPU.

    PYTHONPATH=src python3 tools/lm_sensitivity.py [--width 512]

For each LM config at its published depth and a reduced width (``--width``
for d_model and d_ff, 4 heads, a 2,048-token vocab; MoE at capacity factor
8.0), with params from ``repro_torch.models.transformer.model.init_params``
as drawn (the reference's rule: the fan-in of a [D, H, dh] weight is H) and
with wq and wk rescaled to a fan-in of d_model, as ``chip_smoke.py`` phase
18 draws them, it prints the largest logit change over 2 × 64 tokens from:
params multiplied by 1 + 1e-7·N(0, 1) (f32); bf16 activations against f32;
and one decode step with a float8 KV cache against the bf16 forward.
These are properties of the model's arithmetic, not timings of a device.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch                      # noqa: E402
from repro_torch.models.transformer import model as TM        # noqa: E402

ARCHS = ("qwen1.5-4b", "phi4-mini-3.8b", "granite-moe-3b-a800m")


def _cfg(arch: str, width: int):
    base = get_arch(arch).build_cfg()
    kw = dict(d_model=width, d_ff=width, n_heads=4,
              n_kv_heads=min(base.n_kv_heads, 4), vocab=2048)
    if base.moe:
        kw["moe"] = dataclasses.replace(base.moe, capacity_factor=8.0)
    return get_arch(arch).build_cfg(**kw)


def _rescale(params: dict, cfg) -> dict:
    out = dict(params)
    for name, fan in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads)):
        out[f"layers/{name}"] = params[f"layers/{name}"] \
            * (fan / cfg.d_model) ** 0.5
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=512)
    args = ap.parse_args()
    torch.manual_seed(0)
    for arch in ARCHS:
        cfg = _cfg(arch, args.width)
        c32 = dataclasses.replace(cfg, dtype="float32")
        c8 = dataclasses.replace(cfg, cache_dtype="float8_e4m3fn")
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 64)))
        drawn = TM.init_params(cfg, 1, device="cpu")
        for label, p in (("as drawn", drawn),
                         ("wq, wk rescaled", _rescale(drawn, cfg))):
            f32, _ = TM.forward(p, tok, c32)
            nudged = {k: v * (1 + 1e-7 * torch.randn_like(v))
                      for k, v in p.items()}
            f32n, _ = TM.forward(nudged, tok, c32)
            bf16, _ = TM.forward(p, tok, cfg)
            _, cache = TM.prefill(p, tok[:, :-1], c8, cache_len=70)
            dec, _ = TM.decode_step(p, cache, tok[:, -1], 63, c8)
            print(f"{arch}, {cfg.n_layers} layers, width {args.width}, "
                  f"{label}: |logits| up to {float(f32.abs().max()):.3f}; "
                  f"params x (1 + 1e-7 N) moves them "
                  f"{float((f32n - f32).abs().max()):.3e}; bf16 vs f32 "
                  f"{float((bf16 - f32).abs().max()):.3e}; an f8-cache "
                  f"decode vs the bf16 forward "
                  f"{float((dec - bf16[:, -1]).abs().max()):.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
