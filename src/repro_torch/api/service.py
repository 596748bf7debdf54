"""`PageRankService` of the port — overload-resilient serving of N dynamic
streams (ports ``AdmissionRejected``, ``UpdateRequest``, ``ReadResult``,
``_ReadSnapshot`` and ``PageRankService`` from
``src/repro/api/service.py``).

Many independent dynamic graphs, each with its own
:class:`~repro_torch.api.session.PageRankSession`, fed from per-stream
update queues while rank queries are served continuously.  The policy is
the reference's (:class:`~repro_torch.api.config.ServingConfig`):

* **continuous dispatch + coalescing** — each slot drains on its own
  (a worker thread under :meth:`start`, or per-slot passes of the
  synchronous :meth:`step`); a dispatch folds the stream's queued run into
  one batch (:func:`repro_torch.core.delta.coalesce_batches`);
* **admission control** — bounded per-stream queues shed with a
  machine-readable reason (:class:`AdmissionRejected`, or the oldest
  queued request under ``shed_policy="drop_oldest"``);
* **deadlines / retry / backoff** — a request queued past its deadline is
  shed, one finishing late counts as a miss; transient update failures
  retry with exponential backoff;
* **degraded-mode reads** — :meth:`query`, :meth:`top_k` and
  :meth:`ppr_query` serve from a per-slot read replica, refreshed after
  every dispatch, and report their staleness;
* **watchdog** — dispatches heartbeat
  (:class:`~repro_torch.core.fault_domain.SlotHeartbeat`); a dead or stuck
  slot is failed over from its durable store and its queue drains to the
  respawn;
* **integrity scrubber** — a thread that runs ``verify()`` on idle slots
  whose sessions carry ``EngineConfig(integrity=...)``, never blocking a
  busy one.

Where the port differs:

* The read replica is a :class:`~repro_torch.api.session.ReadView` (clones
  of the ranks and the valid mask, the batch index, and a walk slot's walk
  buffer), not a ``fork()``: the port's fork copies every tensor an update
  writes.
* On a card each slot owns one ``torch.cuda.Stream``, made at construction
  and kept across failovers.  Every device operation on the slot's session
  runs on it: the open, warmup, dispatches, the scrubber's ``verify()``,
  a failover's restore and the read-view refresh; each but the refresh
  ends in a synchronise of that stream.  Degraded reads run on one read
  stream per card and wait on the view's ``ready`` event before they
  gather.  A read view is refreshed under the slot's lock, so its ranks and
  its batch index always belong together; the read path takes a new view
  only when the slot is idle, and re-dates a view that is still current
  when it is not.
* The per-session report rows omit ``bucket_retraces_post_warmup``: the
  port keeps no jit caches; ``retraces_post_warmup`` counts kernel builds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import Counter, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.api.config import EngineConfig, ServingConfig
from repro_torch.api.session import (PageRankSession, ReadView,
                                     StreamBatchResult)
from repro_torch.core import fault_domain as fd
from repro_torch.core import integrity as ig
from repro_torch.core.delta import coalesce_batches, validate_edge_batch
from repro_torch.core.graph import HostGraph
from repro_torch.device import resolve_device


class AdmissionRejected(RuntimeError):
    """A submit was refused by admission control.  ``reason`` is the
    machine-readable dict (``code``, ``stream``, ``queue_depth``,
    ``max_queue_depth``, ``shed_policy``, ``message``) — the same shape a
    shed queued request carries in ``request.shed_reason``."""

    def __init__(self, reason: dict):
        super().__init__(reason.get("message", str(reason)))
        self.reason = reason


@dataclasses.dataclass
class UpdateRequest:
    """One queued edge-update batch for one session slot."""
    uid: int
    stream: int                   # session/slot index
    deletions: np.ndarray
    insertions: np.ndarray
    submitted_s: float = 0.0
    started_s: float = 0.0
    done_s: float = 0.0
    deadline_at_s: Optional[float] = None  # absolute (perf_counter) deadline
    result: Optional[StreamBatchResult] = None
    done: bool = False
    attempts: int = 0             # dispatch attempts consumed (retries + 1)
    deadline_missed: bool = False  # completed after its deadline
    shed: bool = False
    shed_reason: Optional[dict] = None
    error: Optional[str] = None

    @property
    def wait_s(self) -> float:
        return self.started_s - self.submitted_s

    @property
    def exec_s(self) -> float:
        """Dispatch execution time (started → done), excluding queue wait."""
        return self.done_s - self.started_s

    @property
    def latency_s(self) -> float:
        """Queue wait + execution (submit → converged ranks visible)."""
        return self.done_s - self.submitted_s


@dataclasses.dataclass
class ReadResult:
    """One degraded-mode read: the values plus their staleness bound.

    ``staleness_s`` is the age of the read view the values came from,
    counted only while the view diverges from committed state (0 when
    served from live state or from a view at the live batch index);
    ``lag_updates`` the number of update dispatches the live session has
    completed past the view.  Unpacks like the session-level tuple
    (``values, vertices = svc.top_k(...)``) and casts to an array
    (``np.asarray(result)`` → values)."""
    values: np.ndarray
    vertices: Optional[np.ndarray]  # top_k only; None for query
    stream: int
    staleness_s: float
    lag_updates: int
    degraded: bool                  # served from a read view, not live state

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.values)
        return a.astype(dtype) if dtype is not None else a

    def __iter__(self):
        return iter((self.values, self.vertices))


@dataclasses.dataclass
class _ReadSnapshot:
    """Per-slot read replica: the session's ranks-only read view."""
    sess: ReadView
    taken_s: float


class PageRankService:
    """Drive N PageRank sessions as an overload-resilient serving fleet.

    ``graphs`` may be host graphs (sessions are opened over them on
    ``device`` with the shared ``config``) or pre-built sessions, which keep
    their own device.  ``serving`` is the
    :class:`~repro_torch.api.config.ServingConfig` overload policy.
    ``warmup=True`` runs each session's per-batch pipeline once up front so
    recorded latencies are steady-state.

    Two dispatch modes share every policy: the synchronous :meth:`step` /
    :meth:`run_until_drained` and the background mode (:meth:`start` /
    :meth:`stop`), where each slot drains on its own worker thread and a
    watchdog thread polls slot health."""

    def __init__(self, graphs: Sequence[Union[HostGraph, PageRankSession]],
                 *, config: Optional[EngineConfig] = None,
                 serving: Optional[ServingConfig] = None,
                 warmup: bool = True, device="cuda"):
        if not graphs:
            raise ValueError("need at least one graph or session")
        self.serving = serving if serving is not None else ServingConfig()
        if not isinstance(self.serving, ServingConfig):
            raise TypeError(
                "serving must be a ServingConfig, got "
                f"{type(self.serving).__name__} — build one with "
                "repro_torch.api.ServingConfig(...)")
        # -- devices and per-slot streams -------------------------------------
        open_on = (resolve_device(device)
                   if any(not isinstance(g, PageRankSession) for g in graphs)
                   else None)
        self._devices: Dict[int, torch.device] = {
            i: (g.device if isinstance(g, PageRankSession) else open_on)
            for i, g in enumerate(graphs)}
        self._streams: Dict[int, Optional[torch.cuda.Stream]] = {}
        self._read_streams: Dict[torch.device, torch.cuda.Stream] = {}
        for i, dev in self._devices.items():
            if dev.type != "cuda":
                self._streams[i] = None
                continue
            s = torch.cuda.Stream(device=dev)
            # a pre-built session's last writes were queued on the caller's
            # stream
            s.wait_stream(torch.cuda.current_stream(dev))
            self._streams[i] = s
            if dev not in self._read_streams:
                self._read_streams[dev] = torch.cuda.Stream(device=dev)
        self.sessions: List[Optional[PageRankSession]] = []
        for i, g in enumerate(graphs):
            if isinstance(g, PageRankSession):
                self.sessions.append(g)
                continue
            with self._on_slot(i):
                self.sessions.append(PageRankSession.from_graph(
                    g, config=config, device=open_on))
        for s in self.sessions:
            s._service = self       # close() unregisters through this
        if warmup:
            for i, s in enumerate(self.sessions):
                with self._on_slot(i):
                    s.warmup()
        self._lock = threading.RLock()
        self._queues: Dict[int, Deque[UpdateRequest]] = {
            i: deque() for i in range(len(self.sessions))}
        self._inflight: Dict[int, List[UpdateRequest]] = {}
        self.finished: List[UpdateRequest] = []
        self.shed_requests: List[UpdateRequest] = []
        self._uid = 0
        self._deadline_misses = 0
        self._retries = 0
        # durable-slot registry: a closed-or-dead slot respawns from its
        # store via failover(); the dir outlives the session object
        self._store_dirs: Dict[int, Optional[str]] = {
            i: getattr(s, "store_dir", None)
            for i, s in enumerate(self.sessions)}
        self._failovers: List[dict] = []
        # -- watchdog / session fault domain ----------------------------------
        self._heartbeat = fd.SlotHeartbeat()
        self._dead: Dict[int, str] = {}          # slot → why it died
        self._dispatches: Dict[int, int] = {
            i: 0 for i in range(len(self.sessions))}
        self._session_faults: List[fd.SessionFault] = []
        self._watchdog_events: List[dict] = []
        self._recovering: set = set()   # slots mid-failover-drain
        self._slot_gen: Dict[int, int] = {
            i: 0 for i in range(len(self.sessions))}
        # -- integrity scrubber / read-view consistency -----------------------
        # per-slot locks: held for the update portion of a dispatch and its
        # read-view refresh, tried non-blocking by the scrubber and the read
        # path so neither delays serving
        self._slot_locks: Dict[int, threading.Lock] = {
            i: threading.Lock() for i in range(len(self.sessions))}
        self._scrubs_run = 0
        self._last_scrub: Dict[int, float] = {}
        self._scrub_thread: Optional[threading.Thread] = None
        # -- degraded reads ---------------------------------------------------
        self._snapshots: Dict[int, _ReadSnapshot] = {}
        self._query_walls: List[float] = []
        self._query_staleness: List[float] = []
        self._query_lags: List[int] = []
        self._snapshot_refreshes = 0    # proactive (budget-driven) refreshes
        if self.serving.degraded_reads:
            for i in range(len(self.sessions)):
                self._refresh_snapshot(i)
        # -- background dispatch ----------------------------------------------
        self._running = False
        self._wake: Dict[int, threading.Event] = {
            i: threading.Event() for i in range(len(self.sessions))}
        self._workers: Dict[int, threading.Thread] = {}
        self._watchdog_thread: Optional[threading.Thread] = None

    @property
    def slots(self) -> int:
        return len(self.sessions)

    @contextlib.contextmanager
    def _on_slot(self, stream: int):
        """Run the body's device work on the slot's stream (the CPU has
        none) and wait for it at the end, so any thread or stream may read
        the session afterwards."""
        s = self._streams.get(stream)
        if s is None:
            yield
            return
        with torch.cuda.stream(s):
            yield
        s.synchronize()

    @property
    def queue(self) -> List[UpdateRequest]:
        """Flat uid-ordered view over every stream's queued requests
        (compat with the pre-dispatcher single-queue surface)."""
        with self._lock:
            reqs = [r for q in self._queues.values() for r in q]
        return sorted(reqs, key=lambda r: r.uid)

    def queue_depth(self, stream: int) -> int:
        with self._lock:
            return len(self._queues[stream])

    # -- placement -----------------------------------------------------------
    def placements(self) -> Dict[int, Tuple[int, ...]]:
        """Device footprint declared by each live session."""
        return {i: s.device_footprint
                for i, s in enumerate(self.sessions)
                if s is not None and not s.closed}

    def _detach(self, sess: PageRankSession) -> None:
        """Unregister a closing session: its slot empties and its queued
        batches are dropped (slot indices of other streams are stable;
        the slot's durable store dir is retained for failover)."""
        for i, s in enumerate(self.sessions):
            if s is sess:
                self.sessions[i] = None
                with self._lock:
                    self._queues[i].clear()
                    self._snapshots.pop(i, None)
                return

    # -- failover (process + session fault domains) ---------------------------
    def failover(self, stream: int, *, warmup: bool = False) -> dict:
        """Respawn a closed-or-dead slot from its durable store, on the
        slot's device and stream: the session is restored from its newest
        valid checkpoint, catches up by replaying its WAL, and re-occupies
        the same slot index (new submits flow immediately).  Returns the
        recovery row also exposed by :meth:`report`."""
        self._check_stream(stream)
        cur = self.sessions[stream]
        if cur is not None and not cur.closed:
            raise ValueError(f"stream {stream} is still live — failover "
                             "replaces closed or dead slots only")
        store_dir = self._store_dirs.get(stream)
        if store_dir is None:
            raise ValueError(
                f"stream {stream} has no durable store to respawn from "
                "(open its session with durability='wal' + store_dir=)")
        t0 = time.perf_counter()
        with self._on_slot(stream):
            sess = PageRankSession.restore(store_dir,
                                           device=self._devices[stream])
        sess._service = self
        rep = sess.report()
        row = {"stream": stream,
               "recovery_time_s": round(time.perf_counter() - t0, 6),
               "replayed_batches": rep.replayed_batches,
               "restored_batch_index": sess._batch_index}
        if warmup:
            with self._on_slot(stream):
                sess.warmup()
        # the respawn's read view is taken before anyone else can reach it
        view = (self._new_view(stream, sess) if self.serving.degraded_reads
                else None)
        with self._lock:
            self.sessions[stream] = sess
            self._dead.pop(stream, None)
            if view is not None:
                self._snapshots[stream] = view
        self._failovers.append(row)
        return row

    # -- queue management ----------------------------------------------------
    def _check_stream(self, stream: int) -> None:
        if not (0 <= stream < self.slots):
            raise ValueError(f"stream {stream} out of range "
                             f"(service has {self.slots} sessions)")

    def _shed(self, req: UpdateRequest, code: str, message: str) -> dict:
        reason = {"code": code, "stream": req.stream, "uid": req.uid,
                  "queue_depth": len(self._queues[req.stream]),
                  "max_queue_depth": self.serving.max_queue_depth,
                  "shed_policy": self.serving.shed_policy,
                  "message": message}
        req.shed = True
        req.shed_reason = reason
        self.shed_requests.append(req)
        return reason

    def _expire_deadlines(self, stream: int, now: float) -> None:
        """Shed queued requests whose deadline already passed (caller holds
        the lock)."""
        q = self._queues[stream]
        kept: Deque[UpdateRequest] = deque()
        for req in q:
            if req.deadline_at_s is not None and now > req.deadline_at_s:
                self._deadline_misses += 1
                self._shed(req, "deadline_expired",
                           f"request {req.uid} spent "
                           f"{now - req.submitted_s:.3f}s queued, past its "
                           "deadline — shed before dispatch")
            else:
                kept.append(req)
        self._queues[stream] = kept

    def submit(self, stream: int, deletions, insertions, *,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one batch for session ``stream``; returns its uid.

        The batch is validated at admission (malformed batches raise
        ``ValueError`` and never enter a queue).  A full queue sheds per
        ``serving.shed_policy``: ``"reject"`` raises
        :class:`AdmissionRejected`, ``"drop_oldest"`` sheds the oldest
        queued request instead.  ``deadline_s`` overrides
        ``serving.deadline_s`` for this request (measured from now)."""
        self._check_stream(stream)
        sess = self.sessions[stream]
        recoverable = (self.serving.watchdog
                       and self._store_dirs.get(stream) is not None)
        if sess is None or (sess.closed and not recoverable):
            raise ValueError(f"stream {stream} is closed (its session was "
                             "close()d or died; failover() respawns "
                             "durable slots)")
        # a died-but-durable slot keeps accepting (bounded) submits while
        # the watchdog respawns it — the drain delivers them to the respawn
        deletions, insertions = validate_edge_batch(deletions, insertions,
                                                    sess.n)
        now = time.perf_counter()
        dl = deadline_s if deadline_s is not None else self.serving.deadline_s
        with self._lock:
            self._expire_deadlines(stream, now)
            q = self._queues[stream]
            self._uid += 1
            req = UpdateRequest(
                uid=self._uid, stream=stream,
                deletions=deletions, insertions=insertions,
                submitted_s=now,
                deadline_at_s=(now + float(dl)) if dl is not None else None)
            if len(q) >= self.serving.max_queue_depth:
                if self.serving.shed_policy == "reject":
                    reason = self._shed(
                        req, "queue_full",
                        f"stream {stream} queue at depth {len(q)} >= "
                        f"max_queue_depth={self.serving.max_queue_depth}; "
                        "rejecting new submit (shed_policy='reject')")
                    raise AdmissionRejected(reason)
                oldest = q.popleft()        # drop_oldest: recency wins
                self._shed(oldest, "queue_full_dropped_oldest",
                           f"stream {stream} queue full; request "
                           f"{oldest.uid} shed to admit {req.uid} "
                           "(shed_policy='drop_oldest')")
            q.append(req)
        if self._running:
            self._wake[stream].set()
        return req.uid

    def inject_session_fault(self, stream: int, *,
                             after_dispatches: int = 0, kind: str = "dead",
                             stall_s: float = 0.0) -> None:
        """Schedule one serving-slot failure (the session fault domain),
        consumed by the slot's dispatcher: after ``after_dispatches``
        completed dispatches the next dispatch kills the slot's session
        (``kind="dead"``) or stalls its worker for ``stall_s`` seconds
        (``kind="stuck"``, tripping the heartbeat watchdog).  Recovery —
        failover + queue drain — is automatic and recorded in
        :meth:`report`."""
        self._check_stream(stream)
        self._session_faults.append(fd.SessionFault(
            stream=int(stream), after_dispatches=int(after_dispatches),
            kind=kind, stall_s=float(stall_s)))

    def _consume_fault(self, stream: int) -> Optional[fd.SessionFault]:
        with self._lock:
            for i, f in enumerate(self._session_faults):
                if (f.stream == stream
                        and self._dispatches[stream] >= f.after_dispatches):
                    return self._session_faults.pop(i)
        return None

    # -- dispatch ------------------------------------------------------------
    def _take(self, stream: int) -> List[UpdateRequest]:
        """Claim this stream's next dispatch: the whole queued run when
        coalescing, else the single head request (FIFO)."""
        with self._lock:
            self._expire_deadlines(stream, time.perf_counter())
            q = self._queues[stream]
            if not q:
                return []
            if self.serving.coalesce:
                reqs = list(q)
                q.clear()
            else:
                reqs = [q.popleft()]
            self._inflight[stream] = reqs
        return reqs

    def _requeue(self, stream: int, reqs: List[UpdateRequest],
                 gen: int) -> None:
        with self._lock:
            if gen != self._slot_gen[stream]:
                return  # failed over while we held them: the respawn's
                        # drain owns these requests now — do not duplicate
            self._queues[stream].extendleft(reversed(reqs))
            self._inflight.pop(stream, None)

    def _dispatch(self, stream: int, reqs: List[UpdateRequest],
                  gen: int) -> bool:
        """Run one dispatch for ``stream``: coalesce the claimed requests
        into one batch, update with retry/backoff, refresh the read view,
        retire.  Returns False when the slot died (requests re-queued for
        the failover drain)."""
        sv = self.serving
        self._heartbeat.busy(stream)
        try:
            fault = self._consume_fault(stream)
            if fault is not None and fault.kind == "stuck":
                # the stall sits BEFORE the update: nothing has touched
                # session or WAL state, so the watchdog may safely re-drain
                time.sleep(fault.stall_s)
            if fault is not None and fault.kind == "dead":
                sess = self.sessions[stream]
                if sess is not None:
                    # crash-stop, not a clean close(): drop the service
                    # backref first so _detach doesn't run — the slot stays
                    # registered (dead) and its queue survives for the drain
                    sess._service = None
                    sess.close()
            if gen != self._slot_gen[stream]:
                # the watchdog failed this slot over while we stalled: the
                # respawned slot owns these requests now
                with self._lock:
                    self._inflight.pop(stream, None)
                return True
            if len(reqs) == 1:
                dels, ins = reqs[0].deletions, reqs[0].insertions
            else:
                sess = self.sessions[stream]
                n = sess.n if sess is not None else 0
                dels, ins = coalesce_batches(
                    [(r.deletions, r.insertions) for r in reqs], n)
            start = time.perf_counter()
            for req in reqs:
                req.started_s = start
            last_err: Optional[BaseException] = None
            result = None
            # the slot lock serializes the session-mutating portion of a
            # dispatch (and the read-view refresh after it) against the
            # scrubber and the read path, which only ever try-acquire
            with self._slot_locks[stream]:
                for attempt in range(sv.max_retries + 1):
                    sess = self.sessions[stream]
                    if sess is None or sess.closed:
                        last_err = ValueError(
                            f"stream {stream} session is closed")
                        break           # permanent: no retry can help
                    try:
                        with self._on_slot(stream):
                            result = sess.update(dels, ins)
                        break
                    except ValueError as e:
                        if sess.closed:  # slot died mid-dispatch
                            last_err = e
                            break
                        raise           # rejected batch: caller bug, no retry
                    except Exception as e:  # transient: backoff and retry
                        last_err = e
                        result = None
                        if attempt < sv.max_retries:
                            with self._lock:
                                self._retries += 1
                            time.sleep(sv.retry_backoff_s * (2 ** attempt))
                if result is not None and sv.degraded_reads:
                    self._refresh_snapshot(stream)
            for req in reqs:
                req.attempts = attempt + 1
            if result is None:
                for req in reqs:
                    req.error = repr(last_err)
                self._requeue(stream, reqs, gen)
                with self._lock:
                    if gen == self._slot_gen[stream]:
                        self._dead.setdefault(stream, repr(last_err))
                return False
            done = time.perf_counter()
            with self._lock:
                if gen != self._slot_gen[stream]:
                    # the watchdog declared us stuck mid-update and drained
                    # these requests to a respawned slot — retiring them too
                    # would double-apply, so abandon them
                    return True
                for req in reqs:
                    req.result = result
                    req.done_s = done
                    req.done = True
                    if (req.deadline_at_s is not None
                            and done > req.deadline_at_s):
                        req.deadline_missed = True
                        self._deadline_misses += 1
                self.finished.extend(reqs)
                self._inflight.pop(stream, None)
                self._dispatches[stream] += 1
            return True
        finally:
            self._heartbeat.idle(stream)

    # -- watchdog (session fault domain) -------------------------------------
    def _slot_has_work(self, stream: int) -> bool:
        with self._lock:
            return bool(self._queues[stream]) or stream in self._inflight

    def _poll_watchdog(self) -> int:
        """One health pass over every slot: fail over dead slots and
        heartbeat-stale (stuck) ones, draining their queued batches to the
        respawned session.  Returns the number of recoveries performed."""
        if not self.serving.watchdog:
            return 0
        recovered = 0
        for i in range(self.slots):
            sess = self.sessions[i]
            dead = (i in self._dead
                    or (sess is not None and sess.closed))
            stuck = self._heartbeat.stale(
                i, self.serving.heartbeat_timeout_s)
            if (dead or stuck) and self._slot_has_work(i):
                if self._failover_drain(
                        i, kind="stuck" if stuck and not dead else "dead"):
                    recovered += 1
        return recovered

    def _failover_drain(self, stream: int, *, kind: str) -> bool:
        """Recover one failed slot: respawn its session from the durable
        store (:meth:`failover`) and drain every claimed-or-queued batch to
        the respawn.  Slots with no store shed their queue instead (with a
        machine-readable reason).  The event lands as a session-domain
        ``RecoveryRecord`` in the respawned session's ``report()`` and under
        ``report()["watchdog"]``."""
        t0 = time.perf_counter()
        with self._lock:
            # mark the slot mid-recovery so run_until_drained() doesn't
            # mistake the held-for-drain window for an idle service
            self._recovering.add(stream)
            stranded = (self._inflight.pop(stream, [])
                        + list(self._queues[stream]))
            self._queues[stream].clear()
            self._slot_gen[stream] += 1     # zombie workers see a stale gen
            gen = self._slot_gen[stream]
        try:
            sess = self.sessions[stream]
            if kind == "stuck" and sess is not None and not sess.closed:
                # close the stuck session: a zombie worker waking later hits
                # "session is closed" before any WAL append (backref dropped
                # first so _detach doesn't unregister the slot)
                sess._service = None
                sess.close()
            if self._store_dirs.get(stream) is None:
                with self._lock:
                    for req in stranded:
                        self._shed(req, "slot_dead",
                                   f"stream {stream} {kind} with no durable "
                                   "store to respawn from — request shed")
                    self._dead[stream] = f"{kind}; no durable store"
                    self._watchdog_events.append(fd.RecoveryRecord(
                        domain="session", batch_index=-1,
                        wall_time_s=time.perf_counter() - t0,
                        stream=stream, kind=kind,
                        drained_requests=0,
                        description=(f"slot {stream} {kind}; no store — "
                                     f"{len(stranded)} request(s) shed")
                    ).to_dict())
                return False
            self.failover(stream)
            with self._lock:
                # prepend: submits admitted while the respawn restored came
                # AFTER the stranded batches, and delta batches are
                # order-sensitive
                self._queues[stream].extendleft(reversed(stranded))
            rec = fd.RecoveryRecord(
                domain="session",
                batch_index=self.sessions[stream]._batch_index,
                wall_time_s=time.perf_counter() - t0,
                stream=stream, kind=kind, drained_requests=len(stranded),
                replayed_batches=(self.sessions[stream]
                                  .report().replayed_batches),
                description=(f"slot {stream} {kind} — respawned from "
                             f"store, {len(stranded)} queued batch(es) "
                             "drained to the new session"))
            self.sessions[stream]._recoveries.append(rec)
            with self._lock:
                self._watchdog_events.append(rec.to_dict())
            if self._running:
                self._spawn_worker(stream, gen)
                self._wake[stream].set()
            return True
        finally:
            with self._lock:
                self._recovering.discard(stream)

    # -- integrity scrubber (corruption fault domain) -------------------------
    def _scrub_eligible(self, stream: int) -> Optional[PageRankSession]:
        sess = self.sessions[stream]
        if sess is None or sess.closed or sess.config.integrity is None:
            return None
        return sess

    def _verify_locked(self, stream: int, sess: PageRankSession, *,
                       deep: bool, repair: Optional[bool]
                       ) -> Optional["ig.IntegrityReport"]:
        """One ``verify()`` on the slot's stream (caller holds the slot
        lock); a repair refreshes the read view under the same lock.
        ``None`` when the session closed before the check."""
        try:
            with self._on_slot(stream):
                rep = sess.verify(deep=deep, repair=repair)
        except ValueError:          # closed between check and acquire
            return None
        if self.serving.degraded_reads and rep.repairs:
            self._refresh_snapshot(stream)
        with self._lock:
            self._scrubs_run += 1
            self._last_scrub[stream] = time.perf_counter()
        return rep

    def scrub(self, stream: Optional[int] = None, *, deep: bool = True,
              repair: Optional[bool] = None
              ) -> Dict[int, "ig.IntegrityReport"]:
        """One synchronous integrity pass (:meth:`PageRankSession.verify`)
        over ``stream`` (or every eligible slot) — the deterministic form
        of the background scrubber.  Slots whose sessions carry no
        ``EngineConfig(integrity=…)`` are skipped.  Returns the per-slot
        :class:`~repro_torch.core.integrity.IntegrityReport` map; repairs
        refresh the slot's read view so repaired state serves at once."""
        streams = range(self.slots) if stream is None else [stream]
        out: Dict[int, ig.IntegrityReport] = {}
        for i in streams:
            self._check_stream(i)
            sess = self._scrub_eligible(i)
            if sess is None:
                continue
            with self._slot_locks[i]:
                rep = self._verify_locked(i, sess, deep=deep, repair=repair)
            if rep is not None:
                out[i] = rep
        return out

    def _scrub_pass(self) -> int:
        """One background-scrubber sweep: verify each eligible slot whose
        ``scrub_interval_s`` has elapsed, skipping (never blocking) slots
        mid-dispatch.  Returns the number of slots scrubbed."""
        done = 0
        for i in range(self.slots):
            sess = self._scrub_eligible(i)
            if sess is None:
                continue
            interval = sess.config.integrity.scrub_interval_s
            if (time.perf_counter()
                    - self._last_scrub.get(i, 0.0)) < interval:
                continue
            lock = self._slot_locks[i]
            if not lock.acquire(blocking=False):
                continue                # busy slot: next pass gets it
            try:
                rep = self._verify_locked(i, sess, deep=True, repair=None)
            finally:
                lock.release()
            if rep is not None:
                done += 1
        return done

    def _scrub_loop(self) -> None:
        intervals = [s.config.integrity.scrub_interval_s
                     for s in self.sessions
                     if s is not None and s.config.integrity is not None]
        poll = min(0.25, max(0.01, min(intervals, default=0.25) / 4))
        while self._running:
            self._scrub_pass()
            time.sleep(poll)

    # -- synchronous dispatch -------------------------------------------------
    def step(self) -> int:
        """One synchronous dispatch pass: every slot with queued work runs
        one dispatch (the whole coalesced run per slot), then the watchdog
        polls slot health.  Returns the number of requests retired."""
        if self._running:
            raise RuntimeError("service is running in background mode — "
                               "stop() it before stepping synchronously")
        before = len(self.finished)
        for i in range(self.slots):
            reqs = self._take(i) if self.sessions[i] is not None else []
            if reqs:
                self._dispatch(i, reqs, self._slot_gen[i])
        self._poll_watchdog()
        return len(self.finished) - before

    def run_until_drained(self, max_ticks: int = 10_000
                          ) -> List[UpdateRequest]:
        """Dispatch until every queue is empty; returns the retired
        requests.  In background mode this just waits for the workers."""
        if self._running:
            deadline = time.time() + 600
            while time.time() < deadline:
                with self._lock:
                    busy = (any(self._queues[i] for i in self._queues)
                            or bool(self._inflight)
                            or bool(self._recovering))
                if not busy:
                    break
                time.sleep(0.01)
            return self.finished
        for _ in range(max_ticks):
            if not self.queue:
                break
            self.step()
        return self.finished

    # -- background dispatch --------------------------------------------------
    def _worker_loop(self, stream: int, gen: int) -> None:
        ev = self._wake[stream]
        while self._running and gen == self._slot_gen[stream]:
            reqs = (self._take(stream)
                    if self.sessions[stream] is not None else [])
            if reqs:
                if not self._dispatch(stream, reqs, gen):
                    return          # slot died; the watchdog takes over
                continue            # drain continuously while work exists
            ev.clear()
            ev.wait(timeout=0.05)

    def _watchdog_loop(self) -> None:
        interval = min(0.1, self.serving.heartbeat_timeout_s / 4)
        while self._running:
            self._poll_watchdog()
            time.sleep(interval)

    def _spawn_worker(self, stream: int, gen: int) -> None:
        t = threading.Thread(target=self._worker_loop, args=(stream, gen),
                             name=f"pagerank-slot-{stream}", daemon=True)
        self._workers[stream] = t
        t.start()

    def start(self) -> "PageRankService":
        """Enter background mode: one dispatcher thread per slot plus a
        watchdog thread (and the scrubber when a slot has ``integrity=``).
        Safe to submit/query from any thread while running."""
        if self._running:
            return self
        self._running = True
        for i in range(self.slots):
            self._spawn_worker(i, self._slot_gen[i])
        if self.serving.watchdog:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="pagerank-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        if self.serving.scrub and any(
                self._scrub_eligible(i) is not None
                for i in range(self.slots)):
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="pagerank-scrubber",
                daemon=True)
            self._scrub_thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Leave background mode.  ``drain=True`` waits for the queues to
        empty first (shed/expired requests are not waited on)."""
        if not self._running:
            return
        if drain:
            self.run_until_drained()
        self._running = False
        for ev in self._wake.values():
            ev.set()
        for t in self._workers.values():
            t.join(timeout=10)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=10)
            self._watchdog_thread = None
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=10)
            self._scrub_thread = None
        self._workers.clear()

    def __enter__(self) -> "PageRankService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop(drain=exc_type is None)
        return False

    # -- degraded-mode reads --------------------------------------------------
    def _new_view(self, stream: int, sess: PageRankSession) -> _ReadSnapshot:
        s = self._streams.get(stream)
        with (torch.cuda.stream(s) if s is not None
              else contextlib.nullcontext()):
            view = sess._read_view()
        return _ReadSnapshot(view, time.perf_counter())

    def _refresh_snapshot(self, stream: int) -> bool:
        """Replace the slot's read view (caller holds the slot lock, so no
        update runs between the clone and its batch index)."""
        sess = self.sessions[stream]
        if sess is None or sess.closed:
            return False
        snap = self._new_view(stream, sess)
        with self._lock:
            self._snapshots[stream] = snap
        return True

    def _restamp(self, stream: int, snap: _ReadSnapshot) -> bool:
        """Date a still-current view to now, unless a newer one replaced it
        meanwhile."""
        with self._lock:
            if self._snapshots.get(stream) is not snap:
                return False
            self._snapshots[stream] = dataclasses.replace(
                snap, taken_s=time.perf_counter())
        return True

    def _read(self, stream: int, op) -> ReadResult:
        self._check_stream(stream)
        t0 = time.perf_counter()
        snap = self._snapshots.get(stream) if self.serving.degraded_reads \
            else None
        live = self.sessions[stream]
        if snap is not None:
            # refresh proactively at a fraction of the budget so served
            # staleness stays under budget.  An idle slot takes a new view;
            # a dispatching one holds its lock, and while it has committed
            # nothing past the view, the view is what a fork taken now would
            # hold (the reference's refresh), so it is only re-stamped
            refresh_at = (self.serving.staleness_budget_s
                          * self.serving.snapshot_refresh_frac)
            if (t0 - snap.taken_s > refresh_at
                    and live is not None and not live.closed):
                lock = self._slot_locks[stream]
                if lock.acquire(blocking=False):
                    try:
                        refreshed = self._refresh_snapshot(stream)
                    finally:
                        lock.release()
                else:
                    refreshed = (live._batch_index == snap.sess.batch_index
                                 and self._restamp(stream, snap))
                if refreshed:
                    with self._lock:
                        self._snapshot_refreshes += 1
                    snap = self._snapshots.get(stream, snap)
            op_start = time.perf_counter()
            rs = self._read_streams.get(snap.sess.device)
            with (torch.cuda.stream(rs) if rs is not None
                  else contextlib.nullcontext()):
                values, vertices = op(snap.sess)
            lag = 0
            if live is not None:
                # a closed (mid-failover) session's batch index is still
                # the committed high-water mark for the stream
                lag = max(0, live._batch_index - snap.sess.batch_index)
                if not live.closed:
                    live._queries += 1  # degraded reads count for the slot
            # staleness = the age of the served data when the read began,
            # and only while the view diverges from committed state
            stale = (max(0.0, op_start - snap.taken_s) if lag > 0 else 0.0)
            res = ReadResult(values=values, vertices=vertices,
                             stream=stream, staleness_s=stale,
                             lag_updates=lag, degraded=True)
        else:
            if live is None or live.closed:
                raise ValueError(f"stream {stream} is closed and "
                                 "degraded reads are disabled")
            # a live read queues behind the slot's work on its stream
            with self._on_slot(stream):
                values, vertices = op(live)
            res = ReadResult(values=values, vertices=vertices,
                             stream=stream, staleness_s=0.0,
                             lag_updates=0, degraded=False)
        with self._lock:
            self._query_walls.append(time.perf_counter() - t0)
            self._query_staleness.append(res.staleness_s)
            self._query_lags.append(res.lag_updates)
        return res

    def query(self, stream: int, vertices) -> ReadResult:
        """Ranks of the given vertices, served degraded-mode (from the
        slot's read view — never waiting on an in-flight update) with the
        staleness bound reported on the result."""
        return self._read(stream, lambda s: (s.query(vertices), None))

    def top_k(self, stream: int, k: int) -> ReadResult:
        """(values, vertex ids) of the k highest-ranked vertices, served
        degraded-mode with the staleness bound reported on the result."""
        return self._read(stream, lambda s: tuple(s.top_k(k)))

    def ppr_query(self, stream: int, seeds, k: int) -> ReadResult:
        """(values, vertex ids) of the k highest **personalized** PageRank
        estimates for the caller's seed set — the per-user ranking read —
        served degraded-mode like :meth:`top_k` (a walk slot's read view
        holds a clone of its walk buffer).  Streams whose engine lacks the
        ``"ppr"`` capability raise
        :class:`~repro_torch.api.registry.CapabilityError`."""
        return self._read(stream, lambda s: tuple(s.ppr_query(seeds, k)))

    # -- reporting -----------------------------------------------------------
    @staticmethod
    def _pct(vals, q) -> float:
        return round(float(np.percentile(vals, q)) * 1e3, 3) if vals else 0.0

    def report(self) -> dict:
        """Per-session p50/p95 update latency + kernel builds after warmup,
        plus the service-level serving health: request/queue-wait/execution
        percentiles, shed + deadline-miss + retry counters, degraded-read
        latency and staleness, and the watchdog event log."""
        per_session = []
        for i, s in enumerate(self.sessions):
            if s is None or s.closed:
                per_session.append({"stream": i, "closed": True})
                continue
            rep = s.report()
            row = {
                "stream": i,
                "n": s.n,
                "engine": rep.engine,
                "devices": list(s.device_footprint),
                "n_updates": rep.n_updates,
                "p50_ms": round(rep.p50_s * 1e3, 3),
                "p95_ms": round(rep.p95_s * 1e3, 3),
                "retraces_post_warmup": rep.retraces_post_warmup,
                "total_sweeps": rep.total_sweeps,
                "total_edges_processed": rep.total_edges_processed,
                "queries_served": rep.queries_served,
                "batches_converged": rep.batches_converged,
                "sweep_cap_hits": rep.sweep_cap_hits,
                "driver": rep.driver,
                "sweeps_history": rep.sweeps_history,
                "edges_processed_history": rep.edges_processed_history,
            }
            if rep.driver == "push":
                row["residual_mass_last"] = rep.residual_mass_last
                row["pushed_blocks"] = rep.pushed_blocks
            if rep.durability != "none" or rep.recoveries:
                row["durability"] = rep.durability
                row["recoveries"] = rep.recoveries
                row["recovery_time_s"] = round(rep.recovery_time_s, 6)
                row["replayed_batches"] = rep.replayed_batches
            if rep.integrity is not None:
                row["integrity"] = rep.integrity
            per_session.append(row)
        with self._lock:
            fin = list(self.finished)
            shed = list(self.shed_requests)
            q_walls = list(self._query_walls)
            q_stale = list(self._query_staleness)
            q_lags = list(self._query_lags)
            queued = sum(len(q) for q in self._queues.values()) \
                + sum(len(v) for v in self._inflight.values())
            watchdog = list(self._watchdog_events)
            deadline_misses = self._deadline_misses
            retries = self._retries
        lat = [r.latency_s for r in fin]
        waits = [r.wait_s for r in fin]
        execs = [r.exec_s for r in fin]
        out = {
            "n_sessions": self.slots,
            "serving": {f.name: getattr(self.serving, f.name)
                        for f in dataclasses.fields(self.serving)},
            "placements": {str(i): list(fp)
                           for i, fp in self.placements().items()},
            "requests_done": len(fin),
            "requests_queued": queued,
            "requests_shed": len(shed),
            "shed_reasons": dict(Counter(
                r.shed_reason["code"] for r in shed if r.shed_reason)),
            "deadline_misses": deadline_misses,
            "retries": retries,
            "request_p50_ms": self._pct(lat, 50),
            "request_p95_ms": self._pct(lat, 95),
            "queue_wait_p50_ms": self._pct(waits, 50),
            "queue_wait_p95_ms": self._pct(waits, 95),
            "exec_p50_ms": self._pct(execs, 50),
            "queries": {
                "served": len(q_walls),
                "p50_ms": self._pct(q_walls, 50),
                "p95_ms": self._pct(q_walls, 95),
                "staleness_p95_s": (round(float(np.percentile(q_stale, 95)),
                                          9) if q_stale else 0.0),
                "staleness_max_s": (round(max(q_stale), 9)
                                    if q_stale else 0.0),
                "lag_updates_max": max(q_lags) if q_lags else 0,
                "snapshot_refreshes": self._snapshot_refreshes,
            },
            "failovers": list(self._failovers),
            "watchdog": watchdog,
            "sessions": per_session,
        }
        rows = [r.get("integrity") for r in per_session
                if r.get("integrity") is not None]
        if rows or self._scrubs_run:
            repairs: Counter = Counter()
            for r in rows:
                repairs.update(r.get("repairs", {}))
            out["integrity"] = {
                "scrubs_run": self._scrubs_run,
                "checks_run": sum(r["checks_run"] for r in rows),
                "corruption_detected": sum(r["corruption_detected"]
                                           for r in rows),
                "repairs": dict(repairs),
            }
        return out
