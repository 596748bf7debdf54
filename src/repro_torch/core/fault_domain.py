"""Fault domains of the port: the thread, shard, process, session and
corruption domains (ports ``DOMAINS``, ``RecoveryRecord``, ``FaultDomain``,
``ThreadFaultDomain``, ``ShardFault``, ``ShardFaultDomain``,
``ProcessFaultDomain``, ``SessionFault``,
``CORRUPTION_KINDS``, ``CorruptionFault``, ``CorruptionFaultDomain``,
``SlotHeartbeat`` and ``resolve_thread_plan`` from
``src/repro/core/fault_domain.py``).

The paper's own fault model: pseudo-threads inside one sweep delay or
crash-stop, and surviving capacity re-covers their blocks on later sweeps.
:class:`ThreadFaultDomain` wraps the deterministic
:class:`~repro_torch.core.faults.FaultPlan` behind the domain interface:
``EngineConfig(fault_domain=ThreadFaultDomain(plan))`` is the same as
``EngineConfig(faults=plan)``.

The shard domain is one shard of a ``topology="sharded"`` session that
crashes or stalls mid-drive.  Recovery is the paper's helping one level
up: the surviving shards re-mark the dead shard's unconverged rows as
affected and drive them to convergence; a permanent loss also
re-partitions the vertex space onto the survivors
(:meth:`repro_torch.core.distributed.DistRuntime.shrink`).
:class:`ShardFaultDomain` is the deterministic injection schedule.

The process domain is crash-stop of the whole job; its recovery is
durability: a :class:`~repro_torch.ckpt.checkpoint.SessionStore` holds
atomic rank checkpoints and a write-ahead log of the applied batches, and
``PageRankSession.restore`` replays the log through the normal update path.
:class:`ProcessFaultDomain` carries the store and the checkpoint cadence.
The corruption domain is silent damage to live session state — a flipped
bit in the ranks, the tile pool or its packed index, the slot tables or an
operand mirror, a torn mirror scatter, a corrupted host graph.
:class:`CorruptionFaultDomain` queues such faults for the next ``update``;
``session.verify`` (:mod:`repro_torch.core.integrity`) detects and repairs
them.  Every recovery appends a :class:`RecoveryRecord` that
``session.report()`` surfaces.  The session domain is a serving slot
that dies or stalls: :class:`SessionFault` schedules one
(``PageRankService.inject_session_fault``, ``ChaosEvent.session_fault``),
the service's watchdog reads :class:`SlotHeartbeat` and fails the slot
over from its store.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

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


@dataclasses.dataclass(frozen=True)
class ShardFault:
    """One scheduled shard failure: shard ``shard`` stops participating
    after ``at_sweep`` sweeps of the next drive.  ``permanent=True`` is
    crash-stop (the shards shrink around it); ``False`` is a transient
    stall (the shard rejoins after the drive — the straggler case)."""
    shard: int
    at_sweep: int = 1
    permanent: bool = True


class ShardFaultDomain(FaultDomain):
    """Deterministic shard-crash injection for ``topology="sharded"``
    sessions.  Faults queue FIFO; each ``update`` consumes at most one.
    The session performs the recovery (helping, and on a permanent loss the
    elastic re-partition) and logs a :class:`RecoveryRecord`."""

    name = "shard"

    def __init__(self, faults: Optional[List[ShardFault]] = None):
        self._pending: List[ShardFault] = list(faults or [])

    def inject(self, shard: int, *, at_sweep: int = 1,
               permanent: bool = True) -> ShardFault:
        f = ShardFault(shard=int(shard), at_sweep=int(at_sweep),
                       permanent=bool(permanent))
        self._pending.append(f)
        return f

    def pop_pending(self) -> Optional[ShardFault]:
        return self._pending.pop(0) if self._pending else None

    def clone(self) -> "ShardFaultDomain":
        """Independent copy of the schedule: the domain rides on a frozen,
        shareable config, so each session consumes its own clone."""
        return ShardFaultDomain(list(self._pending))

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def pending_faults(self) -> List[ShardFault]:
        return list(self._pending)

    def validate_for(self, *, topology: str) -> None:
        if topology != "sharded":
            raise ValueError(
                "ShardFaultDomain requires topology='sharded' (the shard "
                "blast radius only exists on a device mesh)")


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


@dataclasses.dataclass(frozen=True)
class SessionFault:
    """One scheduled serving-slot failure: after slot ``stream`` completes
    ``after_dispatches`` dispatches, the next dispatch hits the fault —
    ``kind="dead"`` closes the slot's session before the update touches any
    state, ``kind="stuck"`` stalls the worker ``stall_s`` seconds first."""
    stream: int
    after_dispatches: int = 0
    kind: str = "dead"
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("dead", "stuck"):
            raise ValueError(f"kind={self.kind!r} invalid; expected "
                             "'dead' or 'stuck'")
        if self.kind == "stuck" and self.stall_s <= 0:
            raise ValueError("kind='stuck' needs stall_s > 0")


#: Injectable silent-corruption kinds (see ``session.inject_corruption``):
#: ``rank``  — exponent-range bit flip in one live rank value
#: ``tile``  — bit flip in one live entry of the pull matrix (the dense
#:             pool and the packed index the kernels read, together)
#: ``slot``  — bit flip in the slot tables (a tile_cols column id)
#: ``mirror``— perturb one operand mirror (rb_in) on the device
#: ``scatter_drop`` / ``scatter_dup`` — the NEXT update's operand-mirror
#:             scatter is silently dropped / applied twice (torn scatter)
#: ``graph`` — corrupt the host graph's edge keys (host truth itself), so
#:             only the durable store can repair
CORRUPTION_KINDS = ("rank", "tile", "slot", "mirror",
                    "scatter_drop", "scatter_dup", "graph")


@dataclasses.dataclass(frozen=True)
class CorruptionFault:
    """One scheduled silent corruption.  ``seed`` deterministically picks
    the injection site (vertex, tile, bit); ``index`` pins it explicitly
    instead when not None."""
    kind: str
    index: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.kind not in CORRUPTION_KINDS:
            raise ValueError(f"kind={self.kind!r} invalid; expected one "
                             f"of {list(CORRUPTION_KINDS)}")


class CorruptionFaultDomain(FaultDomain):
    """Deterministic silent-corruption injection for streaming sessions.
    Faults queue FIFO; each ``update`` consumes at most one and applies it
    to live state *before* the batch, so the drive's fused invariants (or
    the next ``verify``) must detect it.  The session repairs it (the
    integrity ladder) and logs a ``RecoveryRecord(domain="corruption")``."""

    name = "corruption"

    def __init__(self, faults: Optional[List[CorruptionFault]] = None):
        self._pending: List[CorruptionFault] = list(faults or [])

    def inject(self, kind: str, *, index: Optional[int] = None,
               seed: int = 0) -> CorruptionFault:
        f = CorruptionFault(kind=str(kind), index=index, seed=int(seed))
        self._pending.append(f)
        return f

    def pop_pending(self) -> Optional[CorruptionFault]:
        return self._pending.pop(0) if self._pending else None

    def clone(self) -> "CorruptionFaultDomain":
        """Independent copy of the schedule: the domain rides on a frozen,
        shareable config, so each session consumes its own clone."""
        return CorruptionFaultDomain(list(self._pending))

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def pending_faults(self) -> List[CorruptionFault]:
        return list(self._pending)

    def validate_for(self, *, topology: str) -> None:
        if topology != "single":
            raise ValueError(
                "CorruptionFaultDomain instruments the single-device "
                "streaming path (device mirrors + tile pool); sharded "
                "sessions take ShardFaultDomain")


class SlotHeartbeat:
    """Per-slot liveness bookkeeping for the service watchdog (the
    reference's, without its ``beat``, ``is_busy`` and ``age_s``, which
    nothing calls).

    A worker marks a slot ``busy`` when it picks up work and ``idle`` when
    it finishes.  ``stale(timeout)`` is the stuck-slot predicate: busy AND
    marked last more than ``timeout`` seconds ago — an idle slot is never
    stale, however long it idles."""

    def __init__(self):
        self._last: Dict[int, float] = {}
        self._busy_since: Dict[int, float] = {}

    def busy(self, slot: int) -> None:
        now = time.perf_counter()
        self._busy_since[slot] = now
        self._last[slot] = now

    def idle(self, slot: int) -> None:
        self._busy_since.pop(slot, None)
        self._last[slot] = time.perf_counter()

    def stale(self, slot: int, timeout_s: float) -> bool:
        if slot not in self._busy_since:
            return False
        return (time.perf_counter() - self._last.get(slot, 0.0)) > timeout_s


def resolve_thread_plan(faults: Any, fault_domain: Any) -> Optional[Any]:
    """The engine-level :class:`FaultPlan` implied by a config's
    ``faults`` / ``fault_domain`` pair (engines consume plans, not
    domains)."""
    if faults is not None:
        return faults
    if isinstance(fault_domain, ThreadFaultDomain):
        return fault_domain.plan
    return None
