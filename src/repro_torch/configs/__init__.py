"""Config registry of the port (ports ``src/repro/configs/__init__.py``):
importing this package registers the LM and GNN architectures and the
paper's own PageRank workload, in the reference's order.  The recsys
architecture (``autoint``) is not ported yet (ROADMAP A 15a)."""
from repro_torch.configs.registry import (ArchSpec, ShapeSpec, get_arch,
                                          iter_cells, list_archs)

# one module per architecture; import order = report order
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    qwen1_5_4b,
    phi4_mini_3_8b,
    nemotron_4_340b,
    granite_moe_3b_a800m,
    mixtral_8x22b,
    gatedgcn,
    egnn,
    graphsage_reddit,
    meshgraphnet,
    pagerank_df,
)

__all__ = ["ArchSpec", "ShapeSpec", "get_arch", "iter_cells", "list_archs"]
