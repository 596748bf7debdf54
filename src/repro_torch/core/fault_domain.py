"""Fault domains of the port: the thread and process domains (ports
``DOMAINS``, ``RecoveryRecord``, ``FaultDomain``, ``ThreadFaultDomain``,
``ProcessFaultDomain`` and ``resolve_thread_plan`` from
``src/repro/core/fault_domain.py``).

The paper's own fault model: pseudo-threads inside one sweep delay or
crash-stop, and surviving capacity re-covers their blocks on later sweeps.
:class:`ThreadFaultDomain` wraps the deterministic
:class:`~repro_torch.core.faults.FaultPlan` behind the domain interface:
``EngineConfig(fault_domain=ThreadFaultDomain(plan))`` is the same as
``EngineConfig(faults=plan)``.

The process domain is crash-stop of the whole job; its recovery is
durability: a :class:`~repro_torch.ckpt.checkpoint.SessionStore` holds
atomic rank checkpoints and a write-ahead log of the applied batches, and
``PageRankSession.restore`` replays the log through the normal update path.
:class:`ProcessFaultDomain` carries the store and the checkpoint cadence.
Every recovery appends a :class:`RecoveryRecord` that ``session.report()``
surfaces.  The shard, session and corruption domains are not ported yet
(ROADMAP items A 14, A 12 and A 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.faults import FaultPlan

DOMAINS = ("thread", "shard", "process", "session", "corruption")


@dataclasses.dataclass(frozen=True)
class RecoveryRecord:
    """One completed recovery, in any domain (the reference's fields, so a
    report reads the same in both packages)."""
    domain: str                    # "thread" | "shard" | "process"
    batch_index: int               # session batch the fault hit (-1: restore)
    wall_time_s: float             # detection → recovered
    description: str = ""
    # -- shard domain ---------------------------------------------------------
    shard: Optional[int] = None
    permanent: Optional[bool] = None
    helped_vertices: int = 0       # un-converged rows surviving shards took
    recovery_sweeps: int = 0
    # -- process domain -------------------------------------------------------
    replayed_batches: int = 0
    # -- session domain (service watchdog) ------------------------------------
    stream: Optional[int] = None   # service slot index the fault hit
    kind: Optional[str] = None     # "dead" | "stuck"
    drained_requests: int = 0      # queued batches re-routed to the respawn
    # -- corruption domain ----------------------------------------------------
    rung: Optional[str] = None     # "frontier" | "rebuild" | "restore"
    check: Optional[str] = None    # the integrity check that detected it

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


class FaultDomain:
    """Base interface: a named blast radius with an injection schedule.
    Concrete domains are plain configuration objects — the session/runtime
    layers own the actual failure handling and call back into them."""

    name: str = "?"

    def validate_for(self, *, topology: str) -> None:
        """Raise when the domain cannot apply to a session topology."""


class ThreadFaultDomain(FaultDomain):
    """Pseudo-thread delays/crashes inside one sweep (paper §5.3, §5.4).

    Wraps a :class:`~repro_torch.core.faults.FaultPlan` — the plan remains
    the deterministic per-(thread, sweep) schedule and device-table
    generator; the domain is how it enters
    :class:`~repro_torch.api.config.EngineConfig`.  Recovery needs no extra
    machinery: unprocessed blocks keep their convergence flags set and
    surviving capacity re-covers them on later sweeps."""

    name = "thread"

    def __init__(self, plan: Optional[FaultPlan] = None, **plan_kw):
        if plan is not None and plan_kw:
            raise ValueError("pass a FaultPlan or FaultPlan kwargs, "
                             "not both")
        self.plan = plan if plan is not None else FaultPlan(**plan_kw)
        if not hasattr(self.plan, "device_tables"):
            raise ValueError("ThreadFaultDomain needs a FaultPlan "
                             "(.device_tables())")

    def validate_for(self, *, topology: str) -> None:
        if topology == "sharded":
            raise ValueError(
                "thread-domain fault simulation is single-device (pseudo-"
                "threads inside one sweep); sharded sessions take "
                "ShardFaultDomain")


class ProcessFaultDomain(FaultDomain):
    """Crash-stop of the whole job.  There is nothing to inject in-process
    — the failure is the process dying — so this domain is pure recovery
    configuration: the durable store the session writes through and the
    checkpoint cadence.  Durable sessions (``EngineConfig(durability=
    "wal")`` + ``store_dir=``) construct it themselves; it is not a valid
    ``fault_domain=`` value."""

    name = "process"

    def __init__(self, store: Any, *, checkpoint_interval: int = 16):
        self.store = store
        self.checkpoint_interval = int(checkpoint_interval)
        if self.checkpoint_interval < 1:
            raise ValueError("checkpoint_interval must be >= 1")

    def validate_for(self, *, topology: str) -> None:
        raise ValueError(
            "ProcessFaultDomain is constructed internally by durable "
            "sessions — configure the process domain with "
            "EngineConfig(durability='wal', checkpoint_interval=…) plus "
            "store_dir= at session construction, not via fault_domain=")


def resolve_thread_plan(faults: Any, fault_domain: Any) -> Optional[Any]:
    """The engine-level :class:`FaultPlan` implied by a config's
    ``faults`` / ``fault_domain`` pair (engines consume plans, not
    domains)."""
    if faults is not None:
        return faults
    if isinstance(fault_domain, ThreadFaultDomain):
        return fault_domain.plan
    return None
