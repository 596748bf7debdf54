"""Session API of the port (ports ``src/repro/api``): the ported subset of
the reference's public surface.

Names of ``repro.api.__all__`` that later slices bring are absent: the
serving surface (``PageRankService``, ``ServingConfig``,
``AdmissionRejected``, ``ReadResult``, ``UpdateRequest``, ``SessionFault``:
ROADMAP A 12), integrity and chaos (``IntegrityConfig``,
``IntegrityReport``, ``ChaosEvent``, ``ChaosPlan``, ``CorruptionFault``,
``CorruptionFaultDomain``: A 11) and the shard domain (``ShardFault``,
``ShardFaultDomain``: A 14).
"""
from repro_torch.api.config import EngineConfig
from repro_torch.api import registry
from repro_torch.api.registry import CapabilityError, Engine, register
from repro_torch.api.session import (PageRankSession, SessionReport,
                                     StreamBatchResult, SweepCapWarning)
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core.fault_domain import RecoveryRecord, ThreadFaultDomain

__all__ = [
    "CapabilityError",
    "EngineConfig",
    "Engine",
    "PageRankSession",
    "RecoveryRecord",
    "SessionReport",
    "SessionStore",
    "StreamBatchResult",
    "SweepCapWarning",
    "ThreadFaultDomain",
    "register",
    "registry",
]
