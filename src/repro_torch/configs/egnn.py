"""egnn — E(n)-equivariant GNN, n_layers=4 d_hidden=64.
[arXiv:2102.09844; paper]

EGNN requires node positions; for the non-geometric assigned datasets
(citation / social graphs) the position channel is a synthetic 3-D embedding
supplied by ``input_specs`` — the equivariant update is exercised
structurally, as noted in DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.gnn.common import GNNConfig


def build_cfg(*, d_feat: int = 1433, n_out: int = 7, task: str = "node_clf",
              **kw) -> GNNConfig:
    base = dict(
        name="egnn", family="egnn", n_layers=4, d_hidden=64,
        aggregator="sum", d_feat=d_feat, n_out=n_out, task=task,
    )
    base.update(kw)
    return GNNConfig(**base)


def smoke_cfg() -> GNNConfig:
    return build_cfg(name="egnn-smoke", n_layers=2, d_hidden=16, d_feat=8,
                     n_out=3)


register(ArchSpec(
    arch_id="egnn",
    family="gnn",
    source="arXiv:2102.09844; paper",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=gnn_shapes(),
    notes="E(n)-equivariant coordinate+feature updates (molecule is the "
          "native fit; other datasets use synthetic positions).",
))
