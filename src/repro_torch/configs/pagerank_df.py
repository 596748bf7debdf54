"""pagerank-df — the paper's own workload: Dynamic-Frontier lock-free
PageRank (Sahu, CS.DC 2024), as a distributed sweep over the production mesh.

Shapes mirror the paper's dataset classes (Table 2) at dry-run scale:
  * web_67m   — power-law web-crawl class (R-MAT-like),   n=2^26, d_avg 16
  * road_64m  — road-network class (near-planar, d_avg 3), n=2^26, d_avg 4
  * social_16m— dense social class,                        n=2^24, d_avg 64
These lower the *distributed DF sweep* (contribution exchange + local pull +
frontier expansion + convergence reduction) — the paper's inner loop — on
the 256/512-chip meshes.  Wall-clock experiments run host-scale graphs via
benchmarks/ (paper Figs 5-9).  (Ports ``src/repro/configs/pagerank_df.py``;
:func:`engine_config` maps onto the port's
:class:`repro_torch.api.config.EngineConfig`.)
"""
from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, ShapeSpec, register


def build_cfg(**kw):
    base = dict(alpha=0.85, tau=1e-10, tau_f_ratio=1e-3, block_size=256,
                exchange="full")
    base.update(kw)
    return base


def smoke_cfg():
    return build_cfg(tau=1e-9)


def engine_config(cfg=None, **overrides):
    """Bridge an arch cfg dict (from :func:`build_cfg` / the sweep registry)
    into a validated :class:`repro_torch.api.config.EngineConfig` for
    session-level runs:
    ``PageRankSession.from_graph(hg, config=engine_config(smoke_cfg()))``.
    ``tau_f_ratio`` is resolved to an absolute ``tau_f``; unknown overrides
    are rejected by ``EngineConfig.from_kwargs``."""
    from repro_torch.api.config import EngineConfig
    cfg = dict(cfg or build_cfg())
    cfg.update(overrides)
    tau = cfg.pop("tau", 1e-10)
    kw = dict(alpha=cfg.pop("alpha", 0.85), tau=tau,
              tau_f=tau * cfg.pop("tau_f_ratio", 1e-3),
              block_size=cfg.pop("block_size", 256))
    cfg.pop("exchange", None)   # distributed-sweep knob, not a session knob
    kw.update(cfg)              # the rest must be EngineConfig keys
    return EngineConfig.from_kwargs(**kw)


register(ArchSpec(
    arch_id="pagerank-df",
    family="pagerank",
    source="the reproduced paper (Sahu, CS.DC 2024)",
    build_cfg=build_cfg,
    smoke_cfg=smoke_cfg,
    shapes=(
        ShapeSpec("web_67m", "sweep",
                  dict(n_vertices=1 << 26, avg_degree=16)),
        ShapeSpec("road_64m", "sweep",
                  dict(n_vertices=1 << 26, avg_degree=4)),
        ShapeSpec("social_16m", "sweep",
                  dict(n_vertices=1 << 24, avg_degree=64)),
    ),
    notes="the reproduction itself; exchange ∈ {full, bf16, delta} is the "
          "§Perf axis (frontier-aware sparse-delta collective).",
))
