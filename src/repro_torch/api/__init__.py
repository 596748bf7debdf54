"""Session API of the port (ports ``src/repro/api``): the reference's
public surface, every name of ``repro.api.__all__``.
"""
from repro_torch.api.config import EngineConfig, ServingConfig
from repro_torch.api import registry
from repro_torch.api.registry import CapabilityError, Engine, register
from repro_torch.api.session import (PageRankSession, SessionReport,
                                     StreamBatchResult, SweepCapWarning)
from repro_torch.api.service import (AdmissionRejected, PageRankService,
                                     ReadResult, UpdateRequest)
from repro_torch.ckpt.checkpoint import SessionStore
from repro_torch.core.chaos import ChaosEvent, ChaosPlan
from repro_torch.core.fault_domain import (CorruptionFault,
                                           CorruptionFaultDomain,
                                           RecoveryRecord, SessionFault,
                                           ShardFault, ShardFaultDomain,
                                           ThreadFaultDomain)
from repro_torch.core.integrity import IntegrityConfig, IntegrityReport

__all__ = [
    "AdmissionRejected",
    "CapabilityError",
    "ChaosEvent",
    "ChaosPlan",
    "CorruptionFault",
    "CorruptionFaultDomain",
    "EngineConfig",
    "Engine",
    "IntegrityConfig",
    "IntegrityReport",
    "PageRankService",
    "PageRankSession",
    "ReadResult",
    "RecoveryRecord",
    "ServingConfig",
    "SessionFault",
    "SessionReport",
    "SessionStore",
    "ShardFault",
    "ShardFaultDomain",
    "StreamBatchResult",
    "SweepCapWarning",
    "ThreadFaultDomain",
    "UpdateRequest",
    "register",
    "registry",
]
