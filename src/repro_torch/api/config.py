"""`EngineConfig` and `ServingConfig` of the port (port ``EngineConfig``,
``SHED_POLICIES`` and ``ServingConfig`` from ``src/repro/api/config.py``).

Same fields and the same construction-time validation as the JAX config.
``engine`` resolves through :mod:`repro_torch.api.registry` (``None`` →
``"pallas"``, or a ``REPRO_ENGINE`` override, validated eagerly;
``topology="sharded"`` resolves ``"distributed"``).  A config that
constructs is one the port runs: ``device_budget_bytes`` tiers a stream
under either driver, and ``topology="sharded"`` runs ``n_shards`` logical
shards, durable or with ``integrity=`` as well.  ``fault_domain=`` takes a
:class:`~repro_torch.core.fault_domain.ThreadFaultDomain` (the same as
``faults=`` its plan), a
:class:`~repro_torch.core.fault_domain.CorruptionFaultDomain` (the pallas
engine's) or a :class:`~repro_torch.core.fault_domain.ShardFaultDomain`
(the sharded topology's), and any other domain the resolved engine
declares, as the reference does: the domain's ``validate_for`` first, then
the engine's declared domains.  The process domain comes from
``durability="wal"`` with a session's ``store_dir=``; a
``ProcessFaultDomain`` given as ``fault_domain=`` gets the reference's
``ValueError``.  ``integrity=`` takes an
:class:`~repro_torch.core.integrity.IntegrityConfig` or its kwargs dict
(the form a store's meta round-trips) and is coerced to the former.

Some fields mean less, or other things, here than in the reference:

* ``engine`` is ``"pallas"`` (the fused frontier engine, whose tile SpMV is
  the hand-written CUDA kernel on the card), ``"blocked"`` (in-order
  Gauss–Seidel sweeps on the hand-written sweep kernel), ``"dense"`` (the
  oracle; its LF mode is the blocked engine), ``"walk"`` (the Monte Carlo
  walk engine, the only one that takes the walk fields and serves
  personalized reads, on the hand-written walk kernels) or
  ``"distributed"`` (the sharded engine, which ``topology="sharded"``
  selects);
* ``backend`` accepts only ``None``: the tensors' device picks the kernel
  (CUDA) or its plain version (CPU), and no setting can put the plain
  version on the card;
* ``n_shards`` counts logical shards on the session's one device, so no
  count exceeds the visible devices (the reference refuses one that
  does), and ``None`` resolves to 1 (the reference: every visible JAX
  device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.api import registry
from repro_torch.device import as_torch_dtype
from repro_torch.graphs.partition import PARTITIONERS

MODES = ("lf", "bb")
ACTIVE_POLICIES = ("affected", "rc")
DRIVERS = ("pull", "push")
TOPOLOGIES = ("single", "sharded")
EXCHANGES = ("full", "bf16", "delta")
DURABILITIES = ("none", "wal")
# load-shedding policies of a full serving queue (ServingConfig):
#   "reject"      — refuse the NEW submit (caller sees AdmissionRejected);
#   "drop_oldest" — shed the oldest queued request to admit the new one
SHED_POLICIES = ("reject", "drop_oldest")

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated, immutable engine configuration (field meanings as in
    ``repro.api.config.EngineConfig``).  ``dtype=None`` resolves to f64, the
    paper's rank type."""

    alpha: float = 0.85
    tau: float = 1e-10
    tau_f: Optional[float] = None
    mode: str = "lf"
    engine: Optional[str] = None
    backend: Optional[str] = None
    tile: int = 512
    block_size: int = 64
    active_policy: str = "affected"
    max_iterations: int = 500
    faults: Optional[Any] = None
    dtype: Optional[Any] = None
    topology: str = "single"
    n_shards: Optional[int] = None
    partitioner: str = "contiguous"
    exchange: str = "full"
    fault_domain: Optional[Any] = None
    durability: str = "none"
    checkpoint_interval: int = 16
    integrity: Optional[Any] = None
    walks_per_vertex: Optional[int] = None
    walk_length: Optional[int] = None
    walk_seed: Optional[int] = None
    device_budget_bytes: Optional[int] = None
    driver: str = "pull"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"mode={self.mode!r} invalid; expected one of {MODES}")
        if self.active_policy not in ACTIVE_POLICIES:
            raise ValueError(f"active_policy={self.active_policy!r} invalid; "
                             f"expected one of {ACTIVE_POLICIES}")
        if not (0.0 < float(self.alpha) < 1.0):
            raise ValueError(f"alpha={self.alpha} outside (0, 1)")
        if float(self.tau) <= 0:
            raise ValueError(f"tau={self.tau} must be > 0")
        if self.tau_f is not None and float(self.tau_f) <= 0:
            raise ValueError(f"tau_f={self.tau_f} must be > 0 (or None)")
        for name in ("tile", "block_size", "max_iterations"):
            if int(getattr(self, name)) <= 0:
                raise ValueError(f"{name}={getattr(self, name)} must be > 0")
        if self.faults is not None and not hasattr(self.faults,
                                                  "device_tables"):
            raise ValueError(
                "faults must be a FaultPlan (needs .device_tables())")
        if self.dtype is not None:
            as_torch_dtype(self.dtype)
        # -- topology axis: the reference's rules, before anything resolves
        # the engine (the reference's device-count check has no counterpart:
        # the shards are logical)
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology={self.topology!r} invalid; "
                             f"expected one of {TOPOLOGIES}")
        if self.partitioner not in PARTITIONERS:
            raise ValueError(f"partitioner={self.partitioner!r} invalid; "
                             f"expected one of {PARTITIONERS}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"exchange={self.exchange!r} invalid; "
                             f"expected one of {EXCHANGES}")
        if self.n_shards is not None and int(self.n_shards) <= 0:
            raise ValueError(f"n_shards={self.n_shards} must be > 0 "
                             "(or None for one shard)")
        if self.topology == "single":
            if self.n_shards is not None:
                raise ValueError(
                    "n_shards is only meaningful with topology='sharded' "
                    f"(got topology='single', n_shards={self.n_shards})")
            if self.engine == "distributed":
                raise ValueError(
                    "engine='distributed' requires topology='sharded' — "
                    "topology is the config axis that selects it")
        else:
            if self.engine not in (None, "distributed"):
                raise ValueError(
                    f"topology='sharded' resolves engine='distributed'; "
                    f"engine={self.engine!r} cannot run sharded (leave "
                    "engine=None)")
            if self.faults is not None:
                raise ValueError(
                    "fault simulation is not supported with "
                    "topology='sharded' (stragglers are the model: stale "
                    "contributions, no crash tables) — use a single-device "
                    "engine with a FaultPlan")
        if self.integrity is not None:
            # the kwargs-dict form (what a store's meta round-trips through
            # restore()) is coerced in place, as the reference does
            from repro_torch.core.integrity import IntegrityConfig
            object.__setattr__(self, "integrity",
                               IntegrityConfig.coerce(self.integrity))
        # -- engine / backend -------------------------------------------------
        if self.backend is not None:
            raise ValueError(
                f"backend={self.backend!r}: the port has no tile-backend "
                "switch — a CUDA tensor always runs the hand-written kernel "
                "and a CPU tensor (device='cpu', asked for explicitly) its "
                "plain version; leave backend=None")
        if self.driver not in DRIVERS:
            raise ValueError(
                f"driver={self.driver!r} invalid; expected one of {DRIVERS}")
        # -- tiered-storage axis: the reference's checks, before its engine
        # resolution as there
        if self.device_budget_bytes is not None:
            v = self.device_budget_bytes
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise ValueError(
                    f"device_budget_bytes={v!r} must be a positive integer "
                    "(or None for untiered storage)")
            if self.topology != "single":
                raise ValueError(
                    "device_budget_bytes tiers a single device's tile pool; "
                    "topology='sharded' already partitions state across "
                    "devices — the two cannot compose")
            if self.engine not in (None, "pallas"):
                raise ValueError(
                    "device_budget_bytes requires the streaming pallas "
                    f"engine (got engine={self.engine!r})")
        eng_name = registry.resolve(self._engine_for_resolution()).name
        # -- driver axis: the push rules come before every later-slice
        # refusal below, so what the reference refuses for good raises its
        # ValueError here too
        if self.driver == "push":
            if eng_name != "pallas":
                raise ValueError(
                    "driver='push' is the residual forward-push mode of the "
                    f"streaming pallas engine; engine resolves to "
                    f"{eng_name!r} — pass engine='pallas' (or leave the "
                    "default) to select it")
            if self.mode != "lf":
                raise ValueError(
                    "driver='push' has no blocked-barrier analogue; "
                    f"mode must be 'lf' (got {self.mode!r})")
            if self.faults is not None:
                raise ValueError(
                    "driver='push' does not host thread fault tables; "
                    "run fault experiments on driver='pull'")
            if self.fault_domain is not None:
                raise ValueError(
                    "driver='push' does not host fault domains on the drive "
                    "path (durability='wal' still composes); use "
                    "driver='pull' for fault-domain experiments")
            if self.integrity is not None:
                raise ValueError(
                    "integrity invariants instrument the pull iterate; "
                    "driver='push' does not support integrity=")
        # -- fault domains: the domain's own topology rule, then the
        # engine's declared domains
        if self.fault_domain is not None:
            from repro_torch.core.fault_domain import FaultDomain
            if not isinstance(self.fault_domain, FaultDomain):
                raise ValueError(
                    "fault_domain must be a repro_torch.core.fault_domain."
                    "FaultDomain (ThreadFaultDomain / ShardFaultDomain / "
                    f"CorruptionFaultDomain), got "
                    f"{type(self.fault_domain).__name__}")
            if self.faults is not None:
                raise ValueError(
                    "faults= and fault_domain= are mutually exclusive — "
                    "faults=plan is shorthand for "
                    "fault_domain=ThreadFaultDomain(plan)")
            self.fault_domain.validate_for(topology=self.topology)
            eng = registry.resolve(eng_name)
            if self.fault_domain.name not in registry.fault_domains_of(eng):
                raise ValueError(
                    f"engine {eng.name!r} does not host the "
                    f"{self.fault_domain.name!r} fault domain (declares "
                    f"{registry.fault_domains_of(eng)})")
        # -- fault-domain / durability axis -----------------------------------
        if self.durability not in DURABILITIES:
            raise ValueError(f"durability={self.durability!r} invalid; "
                             f"expected one of {DURABILITIES}")
        if int(self.checkpoint_interval) <= 0:
            raise ValueError(f"checkpoint_interval={self.checkpoint_interval}"
                             " must be > 0")
        # -- walk-engine / personalization axis -------------------------------
        for name, lo in (("walks_per_vertex", 1), ("walk_length", 2),
                         ("walk_seed", 0)):
            v = getattr(self, name)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(
                    f"{name} must be an integer (or None), got "
                    f"{type(v).__name__} ({v!r})")
            if v < lo:
                raise ValueError(f"{name}={v} must be >= {lo}")
        # capability gate: personalization fields only reach engines that
        # declare "ppr"; everything else rejects them at construction
        eng = registry.resolve(eng_name)
        registry.reject_personalization(
            eng, {name: getattr(self, name)
                  for name in ("walks_per_vertex", "walk_length",
                               "walk_seed")})
        if "ppr" in registry.supports_of(eng):
            if self.faults is not None:
                raise ValueError(
                    f"engine {eng.name!r} is sweep-free and hosts no "
                    "thread fault domain; faults must be None")
            if self.integrity is not None:
                raise ValueError(
                    "integrity checks instrument the stream-mode "
                    f"pull-matrix state; engine {eng.name!r} does not "
                    "host them (integrity must be None)")

    def _engine_for_resolution(self) -> Optional[str]:
        """Topology-aware engine name: a sharded config always resolves the
        ``distributed`` engine (defaults and ``REPRO_ENGINE`` apply to
        ``single``)."""
        if self.topology == "sharded":
            return self.engine or "distributed"
        return self.engine

    # -- resolution helpers --------------------------------------------------
    @property
    def resolved_engine(self) -> str:
        """Engine name after topology/default/env resolution
        (registry-validated)."""
        return registry.resolve(self._engine_for_resolution()).name

    @property
    def resolved_n_shards(self) -> Optional[int]:
        """Shard count under ``topology="sharded"`` (``None`` → 1: the
        shards are logical); ``None`` for single-device configs."""
        if self.topology != "sharded":
            return None
        return int(self.n_shards) if self.n_shards is not None else 1

    def resolved_tau_f(self, *, expand: bool) -> float:
        if not expand:
            return float("inf")
        return float(self.tau_f) if self.tau_f is not None \
            else float(self.tau) / 1000.0

    def resolved_dtype(self) -> torch.dtype:
        return (torch.float64 if self.dtype is None
                else as_torch_dtype(self.dtype))

    @property
    def resolved_walks_per_vertex(self) -> int:
        """Walk-engine ``R`` after default resolution."""
        from repro_torch.core import walk_engine
        return int(self.walks_per_vertex
                   if self.walks_per_vertex is not None
                   else walk_engine.DEFAULT_WALKS_PER_VERTEX)

    @property
    def resolved_walk_length(self) -> int:
        """Walk-engine ``L`` after default resolution."""
        from repro_torch.core import walk_engine
        return int(self.walk_length if self.walk_length is not None
                   else walk_engine.DEFAULT_WALK_LENGTH)

    @property
    def resolved_walk_seed(self) -> int:
        """Walk-store base seed after default resolution."""
        from repro_torch.core import walk_engine
        return int(self.walk_seed if self.walk_seed is not None
                   else walk_engine.DEFAULT_WALK_SEED)

    # -- strict construction -------------------------------------------------
    @classmethod
    def valid_keys(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_kwargs(cls, **kw) -> "EngineConfig":
        """Build a config, rejecting unknown keys with the valid-key list."""
        unknown = sorted(set(kw) - set(cls.valid_keys()))
        if unknown:
            raise TypeError(
                f"unknown EngineConfig key(s) {unknown}; "
                f"valid keys: {sorted(cls.valid_keys())}")
        return cls(**kw)

    def replace(self, **kw) -> "EngineConfig":
        """``dataclasses.replace`` with the same strict key check."""
        unknown = sorted(set(kw) - set(self.valid_keys()))
        if unknown:
            raise TypeError(
                f"unknown EngineConfig key(s) {unknown}; "
                f"valid keys: {sorted(self.valid_keys())}")
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Validated, immutable serving policy of a
    :class:`~repro_torch.api.service.PageRankService` (field meanings,
    defaults and errors as in ``repro.api.config.ServingConfig``): the
    per-stream admission bound and ``shed_policy``, the default
    ``deadline_s``, ``max_retries`` with exponential ``retry_backoff_s``,
    ``coalesce`` (fold a stream's queued run into one batch per dispatch;
    ``False`` is bit for bit a sequential session), ``degraded_reads``
    from a per-slot read view held to ``staleness_budget_s`` (refreshed on
    the read path past ``snapshot_refresh_frac`` of it), the watchdog's
    ``heartbeat_timeout_s``, and the background ``scrub``ber."""

    max_queue_depth: int = 64
    shed_policy: str = "reject"
    deadline_s: Optional[float] = None
    max_retries: int = 1
    retry_backoff_s: float = 0.02
    coalesce: bool = True
    degraded_reads: bool = True
    staleness_budget_s: float = 0.5
    snapshot_refresh_frac: float = 0.5
    heartbeat_timeout_s: float = 30.0
    watchdog: bool = True
    scrub: bool = True

    def __post_init__(self):
        if int(self.max_queue_depth) < 1:
            raise ValueError(f"max_queue_depth={self.max_queue_depth} "
                             "must be >= 1")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy={self.shed_policy!r} invalid; "
                             f"expected one of {SHED_POLICIES}")
        if self.deadline_s is not None and float(self.deadline_s) < 0:
            raise ValueError(f"deadline_s={self.deadline_s} must be >= 0 "
                             "(or None for no deadline)")
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")
        if float(self.retry_backoff_s) < 0:
            raise ValueError(f"retry_backoff_s={self.retry_backoff_s} "
                             "must be >= 0")
        if float(self.staleness_budget_s) < 0:
            raise ValueError(f"staleness_budget_s={self.staleness_budget_s}"
                             " must be >= 0")
        if not (0.0 < float(self.snapshot_refresh_frac) <= 1.0):
            raise ValueError(
                f"snapshot_refresh_frac={self.snapshot_refresh_frac} "
                "outside (0, 1] — it is the fraction of the staleness "
                "budget at which reads refresh their snapshot")
        if float(self.heartbeat_timeout_s) <= 0:
            raise ValueError(f"heartbeat_timeout_s="
                             f"{self.heartbeat_timeout_s} must be > 0")

    @classmethod
    def valid_keys(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))

    def replace(self, **kw) -> "ServingConfig":
        unknown = sorted(set(kw) - set(self.valid_keys()))
        if unknown:
            raise TypeError(
                f"unknown ServingConfig key(s) {unknown}; "
                f"valid keys: {sorted(self.valid_keys())}")
        return dataclasses.replace(self, **kw)
