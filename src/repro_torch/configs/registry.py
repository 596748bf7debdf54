"""Architecture registry (ports ``src/repro/configs/registry.py``): every
ported architecture (plus the paper's own PageRank workload) registers an
:class:`ArchSpec` here; smoke tests and ``chip_smoke.py`` enumerate cells
through this module.

A *cell* is one (architecture × input-shape) pair.  ``ShapeSpec.kind`` selects
which step function the cell lowers (``train_step`` vs ``serve_step`` etc.);
``skip`` carries the rule-based skip reason (e.g. quadratic attention at 524k
tokens) so skipped cells stay visible in every report.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape for an architecture."""
    name: str
    kind: str            # "train" | "prefill" | "decode" | "full_batch" |
    #                      "sampled" | "batched_small" | "serve" | "retrieval"
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    note: str = ""
    skip: str = ""       # non-empty → cell excluded by rule (recorded, not run)

    def dim(self, key: str, default: Optional[int] = None) -> int:
        if key in self.dims:
            return self.dims[key]
        if default is None:
            raise KeyError(f"shape {self.name} has no dim {key}")
        return default


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One selectable ``--arch`` entry."""
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys" | "pagerank"
    source: str                       # provenance per the assignment table
    build_cfg: Callable[..., Any]     # full-size config (accepts overrides)
    smoke_cfg: Callable[[], Any]      # reduced config for CPU smoke tests
    shapes: Tuple[ShapeSpec, ...]
    # mesh-rule overrides merged over the family base rules (perf knobs live
    # here so the §Perf loop can iterate without touching model code)
    rules_override: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-shape execution overrides, e.g. {"train_4k": {"microbatches": 8}}
    exec_overrides: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name}")

    def exec_for(self, shape_name: str) -> Dict[str, Any]:
        return dict(self.exec_overrides.get(shape_name, {}))


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def iter_cells(include_skipped: bool = False):
    """Yield (ArchSpec, ShapeSpec) for every assigned cell."""
    import repro_torch.configs  # noqa: F401
    for arch_id in sorted(_REGISTRY):
        spec = _REGISTRY[arch_id]
        if spec.family == "pagerank":
            continue  # the paper's own workload is reported separately
        for shape in spec.shapes:
            if shape.skip and not include_skipped:
                continue
            yield spec, shape


# ---------------------------------------------------------------------------
# shared shape sets (assignment: one shape set per family)
# ---------------------------------------------------------------------------

def lm_shapes(*, subquadratic: bool, decode: bool = True,
              long_note: str = "") -> Tuple[ShapeSpec, ...]:
    """The LM-family shape set.  ``long_500k`` lowers ``serve_step`` and is
    skipped for pure full-attention archs (O(L²) at 524k tokens)."""
    long_skip = "" if subquadratic else (
        "full quadratic attention at seq 524,288 — O(L²) scores are "
        "infeasible; arch has no sub-quadratic path (see DESIGN.md "
        "§Arch-applicability)")
    return (
        ShapeSpec("train_4k", "train",
                  dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "prefill",
                  dict(seq_len=32768, global_batch=32)),
        ShapeSpec("decode_32k", "decode",
                  dict(seq_len=32768, global_batch=128)),
        ShapeSpec("long_500k", "decode",
                  dict(seq_len=524288, global_batch=1),
                  note=long_note, skip=long_skip),
    )


def gnn_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("full_graph_sm", "full_batch",
                  dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7)),
        ShapeSpec("minibatch_lg", "sampled",
                  dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                       fanout1=15, fanout2=10, d_feat=602, n_out=41),
                  note="sampled-training: the lowered step consumes the "
                       "sampled block; the full graph lives in the host "
                       "sampler (repro_torch.graphs.sampler)"),
        ShapeSpec("ogb_products", "full_batch",
                  dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                       n_out=47)),
        ShapeSpec("molecule", "batched_small",
                  dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                       n_out=1)),
    )


def recsys_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", dict(batch=65536)),
        ShapeSpec("serve_p99", "serve", dict(batch=512)),
        ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        ShapeSpec("retrieval_cand", "retrieval",
                  dict(batch=1, n_candidates=1000000)),
    )
