"""Seeded, deterministic chaos harness for composed fault soaks (a copy of
``src/repro/core/chaos.py``: ``CHAOS_KINDS``, ``ChaosEvent``, ``ChaosPlan``;
pure numpy, so one seed gives the reference's schedule).

A :class:`ChaosPlan` expands one integer seed into a reproducible schedule
of fault events over a serving stack: silent corruption (the corruption
domain's kinds, :mod:`repro_torch.core.integrity`) composed with the
session domain's slot kills and stalls.  The plan is pure data: the
harness that owns the sessions walks ``events_at(step)`` and applies each
event through the public injection surface
(``session.inject_corruption``; the serving stack's slot faults come with
ROADMAP item A 12).  At most one event lands per (step, stream), so every
injected corruption maps to exactly one detection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import fault_domain as fd

#: Everything a plan can schedule: the corruption kinds plus the
#: session-domain slot faults.
CHAOS_KINDS = fd.CORRUPTION_KINDS + ("slot_dead", "slot_stuck")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: at soak step ``step``, against serving slot
    ``stream``.  ``seed`` parameterizes the injection site (which
    vertex / tile / bit) deterministically."""
    step: int
    stream: int
    kind: str
    seed: int = 0

    def __post_init__(self):
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} "
                             f"(expected one of {list(CHAOS_KINDS)})")

    def corruption(self) -> Optional[fd.CorruptionFault]:
        """The corruption-domain fault for this event, or None for a
        session-domain event."""
        if self.kind in fd.CORRUPTION_KINDS:
            return fd.CorruptionFault(kind=self.kind, seed=self.seed)
        return None

    def session_fault(self, *, stall_s: float = 0.0
                      ) -> Optional[fd.SessionFault]:
        if self.kind == "slot_dead":
            return fd.SessionFault(stream=self.stream, kind="dead")
        if self.kind == "slot_stuck":
            return fd.SessionFault(stream=self.stream, kind="stuck",
                                   stall_s=stall_s)
        return None

    def to_dict(self) -> dict:
        return {"step": int(self.step), "stream": int(self.stream),
                "kind": self.kind, "seed": int(self.seed)}


class ChaosPlan:
    """Deterministic composed-fault schedule.

    ``require`` lists kinds that must appear at least once (the smoke
    scenario requires one trigger per repair-ladder rung); ``rate`` adds
    extra seeded events on top until roughly ``rate`` of the
    (step, stream) grid carries one.  Events never share a
    (step, stream) cell.
    """

    def __init__(self, *, seed: int, steps: int, streams: int,
                 kinds: Sequence[str] = fd.CORRUPTION_KINDS,
                 require: Sequence[str] = (), rate: float = 0.0):
        if steps <= 0 or streams <= 0:
            raise ValueError("steps and streams must be positive")
        kinds = tuple(kinds)
        for k in tuple(require) + kinds:
            if k not in CHAOS_KINDS:
                raise ValueError(f"unknown chaos kind {k!r}")
        if len(require) > steps * streams:
            raise ValueError(
                f"{len(require)} required events do not fit the "
                f"{steps}x{streams} (step, stream) grid")
        self.seed = int(seed)
        self.steps = int(steps)
        self.streams = int(streams)
        rng = np.random.default_rng(self.seed)
        cells = [(s, t) for s in range(steps) for t in range(streams)]
        order = rng.permutation(len(cells))
        events: List[ChaosEvent] = []
        used = set()
        for i, kind in enumerate(require):
            s, t = cells[order[i]]
            used.add((s, t))
            events.append(ChaosEvent(step=s, stream=t, kind=kind,
                                     seed=int(rng.integers(1 << 31))))
        if rate > 0 and kinds:
            for (s, t) in cells:
                if (s, t) in used or rng.random() >= rate:
                    continue
                events.append(ChaosEvent(
                    step=s, stream=t, kind=str(rng.choice(kinds)),
                    seed=int(rng.integers(1 << 31))))
        self.events: Tuple[ChaosEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.stream)))

    def events_at(self, step: int) -> Tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    @property
    def corruption_events(self) -> Tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events
                     if e.kind in fd.CORRUPTION_KINDS)

    def to_dict(self) -> dict:
        return {"seed": self.seed, "steps": self.steps,
                "streams": self.streams,
                "events": [e.to_dict() for e in self.events]}
