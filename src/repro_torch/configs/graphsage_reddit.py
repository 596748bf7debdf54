"""graphsage-reddit — GNN, n_layers=2 d_hidden=128 mean aggregator,
default sample sizes 25-10.  [arXiv:1706.02216; paper]

``minibatch_lg`` uses the paper's own minibatch algorithm: the host-side
neighbor sampler (:mod:`repro_torch.graphs.sampler`) draws dense fanout blocks
(shape-spec fanout 15-10) and the lowered step consumes the hop tensors.
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.common import GNNConfig


def build_cfg(*, d_feat: int = 602, n_out: int = 41, task: str = "node_clf",
              **kw) -> GNNConfig:
    base = dict(
        name="graphsage-reddit", family="graphsage", n_layers=2,
        d_hidden=128, aggregator="mean", sample_sizes=(25, 10),
        d_feat=d_feat, n_out=n_out, task=task,
    )
    base.update(kw)
    return GNNConfig(**base)


def smoke_cfg() -> GNNConfig:
    return build_cfg(name="graphsage-smoke", n_layers=2, d_hidden=16,
                     d_feat=8, n_out=3, sample_sizes=(3, 2))


register(ArchSpec(
    arch_id="graphsage-reddit",
    family="gnn",
    source="arXiv:1706.02216; paper",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=gnn_shapes(),
    notes="mean aggregator + L2-normalized layers; minibatch_lg runs the "
          "true sampled-training path.",
))
