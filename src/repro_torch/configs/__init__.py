"""Config registry of the port (ports ``src/repro/configs/__init__.py``):
importing this package registers the GNN architectures and the paper's own
PageRank workload, in the reference's relative order.  The transformer and
recsys architectures are not ported yet (ROADMAP A 15a)."""
from repro_torch.configs.registry import (ArchSpec, ShapeSpec, get_arch,
                                          iter_cells, list_archs)

# one module per architecture; import order = report order
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    gatedgcn,
    egnn,
    graphsage_reddit,
    meshgraphnet,
    pagerank_df,
)

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "iter_cells", "list_archs"]
