"""GNN model zoo: dispatch by family name (ports
``src/repro/models/gnn/__init__.py``)."""
from repro_torch.models.gnn.common import GNNConfig, GraphBatch
from repro_torch.models.gnn import gatedgcn, egnn, graphsage, meshgraphnet

FAMILIES = {
    "gatedgcn": gatedgcn,
    "egnn": egnn,
    "graphsage": graphsage,
    "meshgraphnet": meshgraphnet,
}


def get_family(cfg: GNNConfig):
    return FAMILIES[cfg.family]


__all__ = ["GNNConfig", "GraphBatch", "FAMILIES", "get_family",
           "gatedgcn", "egnn", "graphsage", "meshgraphnet"]
