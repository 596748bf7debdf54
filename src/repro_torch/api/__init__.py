"""Session API of the port (ports ``src/repro/api``): the ported subset of
the reference's public surface.

Names of ``repro.api.__all__`` that later slices bring are absent: the
serving surface (``PageRankService``, ``ServingConfig``,
``AdmissionRejected``, ``ReadResult``, ``UpdateRequest``, ``SessionFault``:
ROADMAP A 12) and the shard domain (``ShardFault``, ``ShardFaultDomain``:
A 14).
"""
from repro_torch.api.config import EngineConfig
from repro_torch.api import registry
from repro_torch.api.registry import CapabilityError, Engine, register
from repro_torch.api.session import (PageRankSession, SessionReport,
                                     StreamBatchResult, SweepCapWarning)
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core.chaos import ChaosEvent, ChaosPlan
from repro_torch.core.fault_domain import (CorruptionFault,
                                           CorruptionFaultDomain,
                                           RecoveryRecord, ThreadFaultDomain)
from repro_torch.core.integrity import IntegrityConfig, IntegrityReport

__all__ = [
    "CapabilityError",
    "ChaosEvent",
    "ChaosPlan",
    "CorruptionFault",
    "CorruptionFaultDomain",
    "EngineConfig",
    "Engine",
    "IntegrityConfig",
    "IntegrityReport",
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
