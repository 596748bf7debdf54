"""meshgraphnet — GNN, n_layers=15 d_hidden=128 sum aggregator mlp_layers=2,
encode-process-decode with relative-position edge features.
[arXiv:2010.03409; unverified]"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.common import GNNConfig


def build_cfg(*, d_feat: int = 1433, n_out: int = 7, task: str = "node_reg",
              **kw) -> GNNConfig:
    base = dict(
        name="meshgraphnet", family="meshgraphnet", n_layers=15,
        d_hidden=128, aggregator="sum", mlp_layers=2,
        d_feat=d_feat, n_out=n_out, task=task,
    )
    base.update(kw)
    return GNNConfig(**base)


def smoke_cfg() -> GNNConfig:
    return build_cfg(name="meshgraphnet-smoke", n_layers=2, d_hidden=16,
                     d_feat=8, n_out=3)


register(ArchSpec(
    arch_id="meshgraphnet",
    family="gnn",
    source="arXiv:2010.03409; unverified",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=gnn_shapes(),
    notes="regression head (node_reg) everywhere except full_graph_sm / "
          "ogb_products / minibatch_lg which are classification datasets — "
          "those cells use node_clf heads sized by the shape spec.",
))
