"""GraphSAGE (Hamilton et al., arXiv:1706.02216) — mean aggregator (ports
``src/repro/models/gnn/graphsage.py``).

Two execution modes:
  * ``forward``          — full-graph layer-wise:  h' = ReLU(W_s·h + W_n·mean_N(h))
  * ``forward_sampled``  — minibatch with dense sampled neighborhoods from
    :mod:`repro_torch.graphs.sampler`, the paper's minibatch algorithm:
    aggregate hop-2 → hop-1 → seeds.
L2 output normalisation per the paper.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.gnn import common as C


def shapes(cfg: C.GNNConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_hidden
    s: Dict[str, Tuple[int, ...]] = {
        "dec/w": (d, cfg.n_out), "dec/b": (cfg.n_out,),
    }
    d_in = cfg.d_feat
    for i in range(cfg.n_layers):
        s[f"l{i}/w_self"] = (d_in, d)
        s[f"l{i}/w_neigh"] = (d_in, d)
        s[f"l{i}/b"] = (d,)
        d_in = d
    return s


def init(cfg: C.GNNConfig, key, *, device="cuda") -> Dict[str, torch.Tensor]:
    return C.init_from_shapes(shapes(cfg), key, cfg.dtype, device=device)


def _l2norm(h):
    return h * torch.rsqrt(h.square().sum(-1, keepdim=True) + 1e-12)


def _layer(params, i, h_self, h_neigh_mean):
    h = h_self @ params[f"l{i}/w_self"] \
        + h_neigh_mean @ params[f"l{i}/w_neigh"] + params[f"l{i}/b"]
    return _l2norm(F.relu(h))


def forward(params, cfg: C.GNNConfig, g: C.GraphBatch) -> torch.Tensor:
    h = g.nodes
    for i in range(cfg.n_layers):
        neigh = C.mean_aggregate(g, h)
        h = _layer(params, i, h, neigh)
    if cfg.task == "graph_reg":
        h = C.graph_readout(g, h, op="mean")
    return h @ params["dec/w"] + params["dec/b"]


def forward_sampled(params, cfg: C.GNNConfig,
                    feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """feats[k] — features of hop-k nodes, shape [B, f1, …, fk, F].
    len(feats) == n_layers + 1.  Returns seed logits [B, n_out]."""
    assert len(feats) == cfg.n_layers + 1
    h = list(feats)
    # aggregate from the deepest hop inward; after step i, h has one less level
    for i in reversed(range(cfg.n_layers)):
        li = cfg.n_layers - 1 - i          # layer index applied at this step
        h = [_layer(params, li, h[k], h[k + 1].mean(dim=-2))
             for k in range(i + 1)]
    return h[0] @ params["dec/w"] + params["dec/b"]


def loss_fn(params, cfg: C.GNNConfig, g: C.GraphBatch, labels
            ) -> Tuple[torch.Tensor, Dict]:
    loss = C.task_loss(cfg, forward(params, cfg, g), g, labels)
    return loss, {"loss": loss}


def loss_fn_sampled(params, cfg: C.GNNConfig, feats, labels
                    ) -> Tuple[torch.Tensor, Dict]:
    loss = C.node_xent(forward_sampled(params, cfg, feats), labels, None)
    return loss, {"loss": loss}
