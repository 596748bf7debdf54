"""Engines, graph substrate and incremental state of the port (ports
``src/repro/core``), with the reference's ``repro.core.__all__``.

The stream names (``StreamRunner``, ``StreamReport``, ``run_stream``)
resolve lazily (PEP 562), as the reference's session re-exports do:
:mod:`repro_torch.core.stream` imports the api package, which imports
this one.
"""
from repro_torch.core.graph import GraphSnapshot, HostGraph
from repro_torch.core.pagerank import (df_pagerank, dt_pagerank, nd_pagerank,
                                       static_pagerank, reference_pagerank,
                                       numpy_reference, linf, PagerankResult,
                                       default_engine)
from repro_torch.core.pallas_engine import run_pallas, build_pull_matrix
from repro_torch.core.incremental import IncrementalPullMatrix, MatrixAux
from repro_torch.core.faults import FaultPlan, NO_FAULTS

__all__ = [
    "GraphSnapshot", "HostGraph", "df_pagerank", "dt_pagerank",
    "nd_pagerank", "static_pagerank", "reference_pagerank",
    "numpy_reference", "linf", "PagerankResult", "FaultPlan", "NO_FAULTS",
    "default_engine", "run_pallas", "build_pull_matrix",
    "IncrementalPullMatrix", "MatrixAux", "StreamRunner", "StreamReport",
    "run_stream",
]

_STREAM_EXPORTS = ("StreamRunner", "StreamReport", "run_stream")


def __getattr__(name: str):
    if name in _STREAM_EXPORTS:
        from repro_torch.core import stream
        return getattr(stream, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
