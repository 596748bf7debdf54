"""EGNN — E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844; ports
``src/repro/models/gnn/egnn.py``).

    m_ij  = φ_e([h_i, h_j, ‖x_i − x_j‖²])
    x_i'  = x_i + (1/(N−1)) Σ_j (x_i − x_j) · φ_x(m_ij)
    h_i'  = h_i + φ_h([h_i, Σ_j m_ij])

φ_e, φ_h: 2-layer MLPs (SiLU); φ_x: 2-layer MLP → scalar, no output bias
(per the reference implementation, keeps equivariance exact).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gnn import common as C


def shapes(cfg: C.GNNConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_hidden
    s: Dict[str, Tuple[int, ...]] = {
        "enc/w": (cfg.d_feat, d), "enc/b": (d,),
        "dec/w": (d, cfg.n_out), "dec/b": (cfg.n_out,),
    }
    L = cfg.n_layers
    # φ_e: [h_i, h_j, dist²(+edge_feat)] → d
    d_in_e = 2 * d + 1 + cfg.d_edge_feat
    s["layers/e_w0"] = (L, d_in_e, d)
    s["layers/e_b0"] = (L, d)
    s["layers/e_w1"] = (L, d, d)
    s["layers/e_b1"] = (L, d)
    # φ_x: m → 1 (no final bias)
    s["layers/x_w0"] = (L, d, d)
    s["layers/x_b0"] = (L, d)
    s["layers/x_w1"] = (L, d, 1)
    # φ_h: [h, Σm] → d
    s["layers/h_w0"] = (L, 2 * d, d)
    s["layers/h_b0"] = (L, d)
    s["layers/h_w1"] = (L, d, d)
    s["layers/h_b1"] = (L, d)
    return s


def init(cfg: C.GNNConfig, key, *, device="cuda") -> Dict[str, torch.Tensor]:
    return C.init_from_shapes(shapes(cfg), key, cfg.dtype, device=device)


def forward(params, cfg: C.GNNConfig, g: C.GraphBatch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (per-node output [N, n_out] or per-graph, final positions)."""
    assert g.pos is not None, "EGNN requires node positions"
    h = g.nodes @ params["enc/w"] + params["enc/b"]
    x = g.pos.to(h.dtype)
    inv_n = 1.0 / max(g.n_pad - 1, 1)

    def layer(carry, lp):
        h, x = carry
        hs, hd = C.gather_src(g, h), C.gather_dst(g, h)
        xs = C.gather_src(g, x)
        xd = x.index_select(0, g.receivers.clamp(max=g.n_pad - 1))
        rel = xd - xs                                   # x_i − x_j on edge j→i
        dist2 = rel.square().sum(-1, keepdim=True)
        feats = [hd, hs, dist2]
        if g.edge_feat is not None:
            feats.append(g.edge_feat.to(h.dtype))
        m = torch.cat(feats, -1)
        m = F.silu(m @ lp["e_w0"] + lp["e_b0"])
        m = F.silu(m @ lp["e_w1"] + lp["e_b1"])
        m = C.mask_edges(g, m)
        w = C.mask_edges(g, F.silu(m @ lp["x_w0"] + lp["x_b0"]) @ lp["x_w1"])
        x = x + inv_n * C.scatter_sum(g, rel * w)
        agg = C.scatter_sum(g, m)
        dh = torch.cat([h, agg], -1)
        dh = F.silu(dh @ lp["h_w0"] + lp["h_b0"])
        dh = dh @ lp["h_w1"] + lp["h_b1"]
        return (h + dh, x), None

    h, x = C.scan_or_unroll(layer, (h, x), C.layer_stack(params))

    if cfg.task == "graph_reg":
        out = C.graph_readout(g, h, op="sum") @ params["dec/w"] \
            + params["dec/b"]
    else:
        out = h @ params["dec/w"] + params["dec/b"]
    return out, x


def loss_fn(params, cfg: C.GNNConfig, g: C.GraphBatch, labels
            ) -> Tuple[torch.Tensor, Dict]:
    out, _ = forward(params, cfg, g)
    loss = C.task_loss(cfg, out, g, labels)
    return loss, {"loss": loss}
