"""MeshGraphNet (Pfaff et al., arXiv:2010.03409) — encode-process-decode
(ports ``src/repro/models/gnn/meshgraphnet.py``).

    encode:   h = MLP_v(node_feat);  e = MLP_e([rel_pos, |rel_pos|] ⊕ edge_feat)
    process:  ×L:  e' = e + MLP([e, h_s, h_r]);  h' = h + MLP([h, Σ_in e'])
    decode:   out = MLP_d(h)
All MLPs are ``mlp_layers``-deep with LayerNorm (decoder: no LayerNorm).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.gnn import common as C


def _edge_in_dim(cfg: C.GNNConfig) -> int:
    # relative position (3) + its norm (1) when pos present, else raw features
    return 4 + cfg.d_edge_feat


def shapes(cfg: C.GNNConfig) -> Dict[str, Tuple[int, ...]]:
    d, ml = cfg.d_hidden, cfg.mlp_layers
    s: Dict[str, Tuple[int, ...]] = {}
    for name, d_in in (("enc_v", cfg.d_feat), ("enc_e", _edge_in_dim(cfg))):
        for k, shp in C.mlp_shapes(d_in, d, d, ml).items():
            s[f"{name}/{k}"] = shp
    for k, shp in C.mlp_shapes(d, d, cfg.n_out, ml).items():
        s[f"dec/{k}"] = shp
    L = cfg.n_layers
    for k, shp in C.mlp_shapes(3 * d, d, d, ml).items():
        s[f"layers/e_{k}"] = (L,) + shp
    for k, shp in C.mlp_shapes(2 * d, d, d, ml).items():
        s[f"layers/v_{k}"] = (L,) + shp
    return s


def init(cfg: C.GNNConfig, key, *, device="cuda") -> Dict[str, torch.Tensor]:
    return C.init_from_shapes(shapes(cfg), key, cfg.dtype, device=device)


def forward(params, cfg: C.GNNConfig, g: C.GraphBatch) -> torch.Tensor:
    ml = cfg.mlp_layers
    h = C.mlp_apply(params, g.nodes, prefix="enc_v/", n_layers=ml,
                    layernorm=True)

    if g.pos is not None:
        xs, xd = C.gather_src(g, g.pos), C.gather_dst(g, g.pos)
        rel = (xd - xs).to(h.dtype)
        ef = torch.cat(
            [rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], -1)
    else:
        ef = torch.zeros((g.senders.shape[0], 4), dtype=h.dtype,
                         device=h.device)
    if g.edge_feat is not None:
        ef = torch.cat([ef, g.edge_feat.to(h.dtype)], -1)
    e = C.mlp_apply(params, ef, prefix="enc_e/", n_layers=ml, layernorm=True)

    def layer(carry, lp):
        h, e = carry
        hs, hd = C.gather_src(g, h), C.gather_dst(g, h)
        e_new = e + C.mlp_apply(lp, torch.cat([e, hs, hd], -1),
                                prefix="e_", n_layers=ml, layernorm=True)
        agg = C.scatter_sum(g, e_new)
        h_new = h + C.mlp_apply(lp, torch.cat([h, agg], -1),
                                prefix="v_", n_layers=ml, layernorm=True)
        return (h_new, e_new), None

    h, e = C.scan_or_unroll(layer, (h, e), C.layer_stack(params))

    if cfg.task == "graph_reg":
        h = C.graph_readout(g, h, op="mean")
    return C.mlp_apply(params, h, prefix="dec/", n_layers=ml)


def loss_fn(params, cfg: C.GNNConfig, g: C.GraphBatch, labels
            ) -> Tuple[torch.Tensor, Dict]:
    loss = C.task_loss(cfg, forward(params, cfg, g), g, labels)
    return loss, {"loss": loss}
