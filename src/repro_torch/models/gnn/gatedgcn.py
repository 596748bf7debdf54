"""GatedGCN (Bresson & Laurent; benchmarking-GNNs variant, arXiv:2003.00982;
ports ``src/repro/models/gnn/gatedgcn.py``).

Edge-gated message passing:
    ê_ij   = E1·h_i + E2·h_j + E3·e_ij
    e_ij'  = e_ij + ReLU(LN(ê_ij))
    η_ij   = σ(ê_ij) / (Σ_{j'→i} σ(ê_ij') + ε)
    h_i'   = h_i + ReLU(LN(U·h_i + Σ_{j→i} η_ij ⊙ V·h_j))
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gnn import common as C

EPS = 1e-6


def shapes(cfg: C.GNNConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_hidden
    s: Dict[str, Tuple[int, ...]] = {
        "enc/w_node": (cfg.d_feat, d), "enc/b_node": (d,),
        "enc/w_edge": (max(cfg.d_edge_feat, 1), d), "enc/b_edge": (d,),
        "dec/w": (d, cfg.n_out), "dec/b": (cfg.n_out,),
    }
    for k in ("U", "V", "E1", "E2", "E3"):
        s[f"layers/{k}"] = (cfg.n_layers, d, d)
    s["layers/ln_h"] = (cfg.n_layers, d)
    s["layers/ln_e"] = (cfg.n_layers, d)
    return s


def init(cfg: C.GNNConfig, key, *, device="cuda") -> Dict[str, torch.Tensor]:
    return C.init_from_shapes(shapes(cfg), key, cfg.dtype, device=device)


def forward(params, cfg: C.GNNConfig, g: C.GraphBatch) -> torch.Tensor:
    h = g.nodes @ params["enc/w_node"] + params["enc/b_node"]
    ef = (g.edge_feat if g.edge_feat is not None
          else torch.ones((g.senders.shape[0], 1), dtype=h.dtype,
                          device=h.device))
    e = ef @ params["enc/w_edge"] + params["enc/b_edge"]

    def layer(carry, lp):
        h, e = carry
        hs, hd = C.gather_src(g, h), C.gather_dst(g, h)
        e_hat = hd @ lp["E1"] + hs @ lp["E2"] + e @ lp["E3"]
        e_new = e + F.relu(C.layer_norm(e_hat) * lp["ln_e"])
        sig = torch.sigmoid(e_hat)
        num = C.scatter_sum(g, sig * (hs @ lp["V"]))
        den = C.scatter_sum(g, sig) + EPS
        h_new = h + F.relu(C.layer_norm(h @ lp["U"] + num / den) * lp["ln_h"])
        return (h_new, e_new), None

    h, e = C.scan_or_unroll(layer, (h, e), C.layer_stack(params))

    if cfg.task == "graph_reg":
        h = C.graph_readout(g, h, op="mean")
    return h @ params["dec/w"] + params["dec/b"]


def loss_fn(params, cfg: C.GNNConfig, g: C.GraphBatch, labels
            ) -> Tuple[torch.Tensor, Dict]:
    loss = C.task_loss(cfg, forward(params, cfg, g), g, labels)
    return loss, {"loss": loss}
