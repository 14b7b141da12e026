"""Deterministic seeded fault injection for the simulated fleet.

The port's own copy of the reference package's ``core/chaos.py`` (the
port imports nothing of the reference), behaviour unchanged.

The paper treats failure as routine ("spot prices rising above your
maximum bid, machine crashes, etc.") and recovers through the queue's
visibility timeout.  This module makes failure a *scheduled, replayable*
event so the serving tier's churn behaviour can be asserted, not hoped
for.  Six fault kinds:

- ``kill`` — terminate an instance with no warning (a machine crash):
  the next heartbeat from any task on it raises ``Preempted`` and its
  in-flight work resurfaces via visibility timeouts;
- ``revoke`` — deliver a spot-revocation *notice*: ``Instance.revoke_at``
  is set ``notice_seconds`` in the future, the hosting workers observe
  it through ``WorkerContext.revoked()`` and gracefully drain (stop
  admitting, flush prefix publications, requeue in-flight requests),
  and the fleet terminates the instance when the deadline passes;
- ``delay_heartbeat`` — suppress an instance's heartbeat record for
  ``duration`` seconds (a wedged-but-alive machine): the monitor's idle
  alarm eventually fires exactly as for a crashed host;
- ``truncate_blob`` — corrupt one published ``kvprefix/`` page in the
  object store (truncate to half length): hydrating workers must treat
  it as a fetch miss, never crash;
- ``flaky_storage`` — open a ``duration``-second window during which the
  shared object store's ``put_bytes``/``get_bytes`` raise a transient
  ``ConnectionError`` on the *first* attempt per distinct key (then
  succeed), optionally scoped to a key prefix: exercises every caller's
  retry/backoff discipline without ever losing data;
- ``flaky_queue`` — same window for the durable queue's consumer side
  (``receive_batch`` / ``delete``), injected through the queue module's
  per-path fault hook so every lease's own handle on the shared sqlite
  file is faulted, not just one instance.

Everything is deterministic: events carry explicit virtual-time (``at``)
or heartbeat-count (``after_beats``) triggers, victims are an index into
the *sorted* running-instance list, and the helper schedule builders
draw from ``random.Random(seed)`` only.  Two runs with the same seeds
produce the same ``log``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from .clock import Clock
from .fleet import Instance, SpotFleet
from .logs import LogGroup
from .queue import DurableQueue, install_fault_hook
from .storage import ObjectStore


@dataclass
class ChaosEvent:
    """One scheduled fault.  Exactly one of ``at`` (virtual time) or
    ``after_beats`` (cumulative heartbeat count — fires *mid-slice*,
    between two heartbeats of a running payload) should be set."""

    kind: str  # "kill" | "revoke" | "delay_heartbeat" | "truncate_blob"
    #            | "flaky_storage" | "flaky_queue"
    at: Optional[float] = None
    after_beats: Optional[int] = None
    victim: int = 0  # index into sorted eligible targets (mod len)
    notice_seconds: float = 120.0  # revoke: warning before termination
    duration: float = 0.0  # delay_heartbeat / flaky_*: fault window length
    scope: str = ""  # flaky_storage: comma-separated key prefixes ("" = all)

    def __post_init__(self):
        if self.kind not in (
            "kill",
            "revoke",
            "delay_heartbeat",
            "truncate_blob",
            "flaky_storage",
            "flaky_queue",
        ):
            raise ValueError(f"unknown chaos event kind {self.kind!r}")
        if (self.at is None) == (self.after_beats is None):
            raise ValueError("exactly one of at/after_beats must be set")


@dataclass
class ChaosRecord:
    """What actually happened (the determinism test compares these)."""

    kind: str
    target: str
    time: float


class ChaosMonkey:
    """Fires :class:`ChaosEvent` s against a fleet, deterministically.

    ``tick()`` is called by the monitor once per poll (time-triggered
    events); ``on_beat(inst)`` is called from the runner's heartbeat
    path (beat-triggered events, which kill a worker *mid-slice*);
    ``allow_heartbeat(inst)`` gates liveness recording so a
    ``delay_heartbeat`` fault looks exactly like a wedged host.  An
    event whose trigger has passed but which has no eligible target yet
    (e.g. a revoke while nothing is running) stays pending and retries.
    """

    def __init__(
        self,
        fleet: SpotFleet,
        clock: Clock,
        *,
        seed: int = 0,
        events: List[ChaosEvent] = (),
        store: Optional[ObjectStore] = None,
        logs: Optional[LogGroup] = None,
        queue: Optional[DurableQueue] = None,
    ):
        self.fleet = fleet
        self.clock = clock
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.pending: List[ChaosEvent] = list(events)
        self.store = store
        self.logs = logs
        self.queue = queue
        self.log: List[ChaosRecord] = []
        self.counters: Dict[str, int] = {
            "kills": 0,
            "revocations": 0,
            "heartbeat_delays": 0,
            "blobs_truncated": 0,
            "storage_faults": 0,
            "queue_faults": 0,
        }
        self._beats = 0
        self._suppress: Dict[str, float] = {}  # instance id -> until
        # flaky_storage state: the store's put/get are wrapped lazily at
        # first arming and never unwrapped — the wrapper is a pass-through
        # outside the window.  Originals are kept so the monkey's own
        # truncate_blob path bypasses its own faults.
        self._storage_until = 0.0
        self._storage_scope: tuple = ()
        self._storage_failed: set = set()  # (op, key) faulted this window
        self._storage_orig_get = None
        self._storage_orig_put = None
        # flaky_queue state (per-path hook registered lazily at first arming)
        self._queue_until = 0.0
        self._queue_failed: set = set()  # ops faulted this window
        self._queue_hooked = False

    # ------------------------------------------------------- schedule builders
    @classmethod
    def revocation_drill(
        cls,
        fleet: SpotFleet,
        clock: Clock,
        *,
        seed: int,
        n_revocations: int,
        start: float,
        spacing: float,
        notice_seconds: float,
        store: Optional[ObjectStore] = None,
        logs: Optional[LogGroup] = None,
    ) -> "ChaosMonkey":
        """A seeded drill: ``n_revocations`` spot-revocation notices from
        ``start``, roughly ``spacing`` apart (seeded jitter), each with
        ``notice_seconds`` of warning.  Same seed => same schedule."""
        rng = random.Random(seed)
        events, t = [], float(start)
        for _ in range(int(n_revocations)):
            events.append(
                ChaosEvent(
                    kind="revoke",
                    at=t,
                    victim=rng.randrange(1 << 16),
                    notice_seconds=float(notice_seconds),
                )
            )
            t += spacing * (0.5 + rng.random())
        return cls(fleet, clock, seed=seed, events=events, store=store, logs=logs)

    @classmethod
    def recovery_drill(
        cls,
        fleet: SpotFleet,
        clock: Clock,
        *,
        seed: int,
        n_revocations: int,
        start: float,
        spacing: float,
        notice_seconds: float,
        flaky_duration: float = 0.0,
        flaky_scope: str = "",
        store: Optional[ObjectStore] = None,
        logs: Optional[LogGroup] = None,
        queue: Optional[DurableQueue] = None,
    ) -> "ChaosMonkey":
        """The revocation drill plus flaky infrastructure: alongside each
        revocation notice, a ``flaky_duration``-second window of transient
        storage and queue faults opens at the notice time — so every drain
        (checkpoint puts, page publications, requeue acks) and every
        resume (checkpoint gets, hydration fetches) runs against first-
        attempt failures and must survive via retry.  Same seed => same
        schedule, including the flaky windows."""
        rng = random.Random(seed)
        events, t = [], float(start)
        for _ in range(int(n_revocations)):
            events.append(
                ChaosEvent(
                    kind="revoke",
                    at=t,
                    victim=rng.randrange(1 << 16),
                    notice_seconds=float(notice_seconds),
                )
            )
            if flaky_duration > 0:
                events.append(
                    ChaosEvent(
                        kind="flaky_storage",
                        at=t,
                        duration=float(flaky_duration),
                        scope=flaky_scope,
                    )
                )
                events.append(
                    ChaosEvent(kind="flaky_queue", at=t, duration=float(flaky_duration))
                )
            t += spacing * (0.5 + rng.random())
        return cls(
            fleet,
            clock,
            seed=seed,
            events=events,
            store=store,
            logs=logs,
            queue=queue,
        )

    # ---------------------------------------------------------------- triggers
    def tick(self) -> List[ChaosRecord]:
        """Fire every time-triggered event whose moment has come."""
        now = self.clock.now()
        return self._fire_due(
            lambda ev: ev.at is not None and now >= ev.at
        )

    def on_beat(self, inst: Instance) -> None:
        """Advance the global heartbeat counter; fire beat-triggered
        events against the instance that is beating *right now* (the
        only target that is provably mid-payload)."""
        self._beats += 1
        for ev in list(self.pending):
            if ev.after_beats is not None and self._beats >= ev.after_beats:
                if self._apply(ev, target=inst):
                    self.pending.remove(ev)

    def allow_heartbeat(self, inst: Instance) -> bool:
        """False while ``inst`` is under a delay_heartbeat fault (the
        runner then skips recording liveness, so the idle alarm sees a
        silent host)."""
        until = self._suppress.get(inst.id)
        if until is None:
            return True
        if self.clock.now() >= until:
            del self._suppress[inst.id]
            return True
        return False

    # ---------------------------------------------------------------- firing
    def _fire_due(self, due) -> List[ChaosRecord]:
        fired: List[ChaosRecord] = []
        still: List[ChaosEvent] = []
        for ev in self.pending:
            if due(ev) and self._apply(ev):
                fired.append(self.log[-1])
            else:
                still.append(ev)
        self.pending = still
        return fired

    def _victim(self, ev: ChaosEvent) -> Optional[Instance]:
        running = sorted(self.fleet.running(), key=lambda i: i.id)
        if ev.kind == "revoke":
            # a second notice to an already-revoked instance is a no-op
            # in EC2 and would double-count here
            running = [i for i in running if i.revoke_at is None]
        if not running:
            return None
        return running[ev.victim % len(running)]

    def _apply(self, ev: ChaosEvent, target: Optional[Instance] = None) -> bool:
        """Try to fire ``ev``; False = no eligible target yet (stay pending)."""
        now = self.clock.now()
        if ev.kind == "truncate_blob":
            if self.store is None:
                return False
            keys = sorted(i.key for i in self.store.list("kvprefix/"))
            if not keys:
                return False
            key = keys[ev.victim % len(keys)]
            # bypass the monkey's own flaky_storage wrapper: corruption
            # must land deterministically, not bounce off its own fault
            get = self._storage_orig_get or self.store.get_bytes
            put = self._storage_orig_put or self.store.put_bytes
            put(key, get(key)[: len(get(key)) // 2])
            self.counters["blobs_truncated"] += 1
            self._record(ev.kind, key, now)
            return True
        if ev.kind == "flaky_storage":
            if self.store is None:
                return False
            self._arm_flaky_storage(ev, now)
            self._record(ev.kind, ev.scope or "*", now)
            return True
        if ev.kind == "flaky_queue":
            if self.queue is None:
                return False
            self._arm_flaky_queue(ev, now)
            self._record(ev.kind, self.queue.path, now)
            return True
        inst = target if target is not None else self._victim(ev)
        if inst is None:
            return False
        if ev.kind == "kill":
            self.fleet.terminate_instance(inst.id, reason="chaos-kill")
            self.counters["kills"] += 1
        elif ev.kind == "revoke":
            if inst.revoke_at is not None:
                return False
            inst.revoke_at = now + float(ev.notice_seconds)
            self.counters["revocations"] += 1
        elif ev.kind == "delay_heartbeat":
            self._suppress[inst.id] = now + float(ev.duration)
            self.counters["heartbeat_delays"] += 1
        self._record(ev.kind, inst.id, now)
        return True

    # ------------------------------------------------------ flaky windows
    def _arm_flaky_storage(self, ev: ChaosEvent, now: float) -> None:
        """Open (or extend) the transient-storage-fault window.  The
        store's methods are wrapped once; the wrapper injects at most one
        ``ConnectionError`` per (op, key) per window, so any caller with
        a single retry always makes progress and no data is ever lost."""
        if self._storage_orig_put is None:
            self._storage_orig_put = self.store.put_bytes
            self._storage_orig_get = self.store.get_bytes

            def flaky(op, orig):
                def call(key, *a, **kw):
                    self._maybe_storage_fault(op, key)
                    return orig(key, *a, **kw)

                return call

            self.store.put_bytes = flaky("put", self._storage_orig_put)
            self.store.get_bytes = flaky("get", self._storage_orig_get)
        self._storage_until = max(self._storage_until, now + float(ev.duration))
        # comma-separated key prefixes; empty = every key is fair game
        self._storage_scope = tuple(p for p in ev.scope.split(",") if p)
        self._storage_failed.clear()  # fresh window: keys fault again

    def _maybe_storage_fault(self, op: str, key: str) -> None:
        if self.clock.now() >= self._storage_until:
            return
        if self._storage_scope and not any(
            key.startswith(p) for p in self._storage_scope
        ):
            return
        token = (op, key)
        if token in self._storage_failed:
            return
        self._storage_failed.add(token)
        self.counters["storage_faults"] += 1
        if self.logs is not None:
            self.logs.put("chaos", f"flaky_storage: transient {op} fault on {key}")
        raise ConnectionError(f"chaos flaky_storage: transient {op} of {key!r}")

    def _arm_flaky_queue(self, ev: ChaosEvent, now: float) -> None:
        if not self._queue_hooked:
            install_fault_hook(self.queue.path, self._queue_fault)
            self._queue_hooked = True
        self._queue_until = max(self._queue_until, now + float(ev.duration))
        self._queue_failed.clear()

    def _queue_fault(self, op: str, path: str) -> None:
        """Per-path hook called from every ``DurableQueue`` handle on the
        shared file: the first consumer call of each op kind inside the
        window fails transiently; the retry (and everyone after) succeeds."""
        if self.clock.now() >= self._queue_until:
            return
        if op in self._queue_failed:
            return
        self._queue_failed.add(op)
        self.counters["queue_faults"] += 1
        if self.logs is not None:
            self.logs.put("chaos", f"flaky_queue: transient {op} fault on {path}")
        raise ConnectionError(f"chaos flaky_queue: transient {op} on {path!r}")

    def _record(self, kind: str, target: str, now: float) -> None:
        self.log.append(ChaosRecord(kind=kind, target=target, time=now))
        if self.logs is not None:
            self.logs.put("chaos", f"{kind} -> {target} at t={now:.0f}")
