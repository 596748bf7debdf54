"""Fault domains of the port: the thread domain (ports ``FaultDomain``,
``ThreadFaultDomain`` and ``resolve_thread_plan`` from
``src/repro/core/fault_domain.py``).

The paper's own fault model: pseudo-threads inside one sweep delay or
crash-stop, and surviving capacity re-covers their blocks on later sweeps.
:class:`ThreadFaultDomain` wraps the deterministic
:class:`~repro_torch.core.faults.FaultPlan` behind the domain interface:
``EngineConfig(fault_domain=ThreadFaultDomain(plan))`` is the same as
``EngineConfig(faults=plan)``.  The shard, process, session and corruption
domains are not ported yet (ROADMAP items A 14, A 9, A 12 and A 11).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.faults import FaultPlan


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


def resolve_thread_plan(faults: Any, fault_domain: Any) -> Optional[Any]:
    """The engine-level :class:`FaultPlan` implied by a config's
    ``faults`` / ``fault_domain`` pair (engines consume plans, not
    domains)."""
    if faults is not None:
        return faults
    if isinstance(fault_domain, ThreadFaultDomain):
        return fault_domain.plan
    return None
