"""Engine registry — the one place engine names resolve to engine code
(ports ``src/repro/api/registry.py``).

Each core engine module owns its adapter (``as_engine()`` in
:mod:`repro_torch.core.blocked`, :mod:`repro_torch.core.pagerank` (dense),
:mod:`repro_torch.core.pallas_engine` and :mod:`repro_torch.core.walk_engine`);
the registry imports and registers them lazily on first resolve, so the
core modules stay import-cycle-free.  External code can plug in more
engines with :func:`register`.  The reference's ``distributed`` engine is
not ported yet: ``EngineConfig`` refuses it, naming the ROADMAP item that
brings it.

``resolve(None)`` applies :func:`default_engine` and validates a
``REPRO_ENGINE`` environment override *through the registry*.  The
reference's ``resolve_backend`` has no counterpart: a tensor's device picks
the tile SpMV (the kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable


@runtime_checkable
class Engine(Protocol):
    """One engine = a name plus a snapshot-level solve.

    ``run`` converges one (R0, affected0) problem on a snapshot and returns
    ``(ranks [n_pad], SweepStats)``.  ``mat`` / ``aux`` / ``backend`` carry
    the pallas engine's incremental operands (engines that do not consume
    them must reject non-None values, :func:`reject_tile_operands`);
    ``shards`` carries a sharded topology request (engines that do not
    consume it reject non-None values, :func:`reject_shard_spec`)."""

    name: str

    def run(self, g, R0, affected0, *, mode: str, expand: bool,
            alpha: float, tau: float, tau_f: Optional[float],
            max_iterations: int, faults, tile: int, active_policy: str,
            mat=None, aux=None, backend: Optional[str] = None, shards=None):
        ...


class CapabilityError(ValueError):
    """An engine was configured with a capability it does not declare
    (e.g. personalization fields on an engine without ``"ppr"`` in its
    ``supports`` set).  Raised at config construction, never mid-query."""


_REGISTRY: Dict[str, Engine] = {}
_BUILTINS = ("repro_torch.core.blocked",         # blocked
             "repro_torch.core.pagerank",        # dense
             "repro_torch.core.pallas_engine",   # pallas
             "repro_torch.core.walk_engine")     # walk
_builtins_loaded = False


def register(engine: Engine, *, overwrite: bool = False) -> Engine:
    """Register an engine adapter under ``engine.name``."""
    name = getattr(engine, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError("engine must carry a non-empty string .name")
    if not callable(getattr(engine, "run", None)):
        raise ValueError(f"engine {name!r} must define a callable .run")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"engine {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = engine
    return engine


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    import importlib
    for modname in _BUILTINS:
        eng = importlib.import_module(modname).as_engine()
        if eng.name not in _REGISTRY:
            register(eng)


def names() -> Tuple[str, ...]:
    """Registered engine names (builtin engines are loaded first)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def default_engine() -> str:
    """Engine used when a caller passes ``engine=None``: ``"pallas"``.  The
    reference picks pallas on the TPU (its fused production path) and the
    blocked engine elsewhere, a rule about its host; the port's counterpart
    of that path is the pallas engine on the card, and the same engine runs
    its plain kernels on the CPU.  A ``REPRO_ENGINE`` override is validated
    against the registry here — eagerly, with the valid-name list."""
    env = os.environ.get("REPRO_ENGINE")
    if env:
        _ensure_builtins()
        if env not in _REGISTRY:
            raise ValueError(
                f"REPRO_ENGINE={env!r} is not a registered engine; "
                f"registered engines: {sorted(_REGISTRY)}")
        return env
    return "pallas"


def resolve(name: Optional[str] = None) -> Engine:
    """Resolve an engine name (``None`` → :func:`default_engine`) to its
    registered adapter, with a clear error on unknown names."""
    _ensure_builtins()
    name = name or default_engine()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{sorted(_REGISTRY)} (register custom engines via "
            "repro_torch.api.registry.register)") from None


def fault_domains_of(engine: Engine) -> Tuple[str, ...]:
    """Fault domains an engine can host (a ``fault_domains`` class
    attribute; adapters predating it default to thread+process).  The
    blocked and dense engines declare ``("thread", "process")``, the pallas
    engine adds ``"corruption"`` (silent damage to its stream state,
    repaired by ``PageRankSession.verify``).  ``EngineConfig`` checks a
    ``fault_domain=`` against it."""
    return tuple(getattr(engine, "fault_domains", ("thread", "process")))


def supports_of(engine: Engine) -> frozenset:
    """Optional capabilities an engine declares beyond the core
    snapshot-level solve (a ``supports`` class attribute).  The only one is
    ``"ppr"`` (the walk engine's); ``EngineConfig`` and the session read
    it."""
    return frozenset(getattr(engine, "supports", ()))


def reject_personalization(engine: Engine, fields: dict) -> None:
    """Config-time guard (``EngineConfig`` calls it): engines without the
    ``"ppr"`` capability reject the walk/personalization fields (``fields``
    maps field name → configured value; ``None`` = unset)."""
    if "ppr" in supports_of(engine):
        return
    set_fields = sorted(k for k, v in fields.items() if v is not None)
    if set_fields:
        raise CapabilityError(
            f"{set_fields} are personalization fields consumed only by "
            f"engines declaring the 'ppr' capability; engine "
            f"{engine.name!r} declares supports="
            f"{sorted(supports_of(engine))} — use "
            "EngineConfig(engine='walk') for personalized queries")


def reject_tile_operands(engine_name: str, mat, aux,
                         backend: Optional[str]) -> None:
    """Guard for engines that do not consume the pallas engine's
    incremental operands (prebuilt pull matrix / cached aux / backend)."""
    for name, val in (("pallas_mat", mat), ("pallas_aux", aux),
                      ("pallas_backend", backend)):
        if val is not None:
            raise ValueError(
                f"{name} is only consumed by engine='pallas' "
                f"(resolved engine: {engine_name!r})")


def reject_shard_spec(engine_name: str, shards) -> None:
    """Guard for engines that do not consume a sharded topology operand."""
    if shards is not None:
        raise ValueError(
            "shards is only consumed by engine='distributed' "
            f"(resolved engine: {engine_name!r}) — set "
            "EngineConfig(topology='sharded') to route through it")
