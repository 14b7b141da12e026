"""The generic worker — the paper's ``worker/generic-worker.py``.

The port's own copy of the reference package's ``core/worker.py`` (the
port imports nothing of the reference), behaviour unchanged.

Loop contract (paper Step 3, automatic actions 5–6):

1. poll the queue; if no visible jobs after a few polls, shut down;
2. pre-flight ``CHECK_IF_DONE``: if the output prefix already holds
   ``EXPECTED_NUMBER_FILES`` objects of at least ``MIN_FILE_SIZE_BYTES``
   (optionally containing ``NECESSARY_STRING`` in the key), acknowledge
   without recomputing — this is what makes whole-run resubmission cheap;
3. run the payload with a heartbeat context; heartbeats extend the SQS
   visibility lease so long jobs are not stolen, and raise
   :class:`Preempted` the moment the instance is terminated so state is
   abandoned mid-step exactly like a real spot kill;
4. on success acknowledge (delete) the message; on failure do nothing —
   the visibility timeout re-delivers, and the DLQ catches poison jobs.

Payloads are looked up in a registry by name (the ``DOCKERHUB_TAG``
analogue): signature ``payload(job: dict, ctx: WorkerContext) -> dict``.
"""

from __future__ import annotations

import hashlib
import json
import random
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from .clock import Clock, WallClock
from .cluster import TaskDefinition
from .logs import LogGroup, MetricRegistry
from .queue import DurableQueue, Message
from .storage import ObjectStore


class Preempted(Exception):
    """Raised inside a payload when the hosting instance is terminated."""


class NotReady(Exception):
    """Raised by a payload whose prerequisite is not yet available (e.g. a
    step-span job waiting for an earlier span's checkpoint).  The message
    is released back to the queue after ``retry_in`` seconds without
    consuming retry budget."""

    def __init__(self, msg: str, retry_in: float = 10.0):
        super().__init__(msg)
        self.retry_in = retry_in


class LeaseYield(Exception):
    """Raised by a long-lived payload (a serving lease) that has spent
    its per-claim slice budget: the message is *released* (retry budget
    refunded) so the same or another worker resumes it, keeping every
    worker's per-tick work bounded and letting the fleet re-balance
    leases under churn."""

    def __init__(self, msg: str, retry_in: float = 0.0):
        super().__init__(msg)
        self.retry_in = retry_in


def backoff_delay(
    base: float, attempt: int, *, cap: float, key: str, jitter: float = 0.5
) -> float:
    """Capped exponential backoff with deterministic jitter.

    ``min(cap, base * 2**(attempt-1))``, scaled down by up to ``jitter``
    fraction drawn from ``random.Random(f"{key}#{attempt}")`` — the same
    (key, attempt) pair always yields the same delay (schedules replay
    exactly), while distinct keys de-synchronize a thundering herd of
    requeued jobs that would otherwise retry in lockstep."""
    a = max(1, int(attempt))
    delay = min(float(cap), float(base) * (2.0 ** (a - 1)))
    if jitter and delay > 0:
        delay *= 1.0 - jitter * random.Random(f"{key}#{a}").random()
    return delay


def _stable_key(msg: Message) -> str:
    """A run-to-run stable jitter key for a message: its *content* hash.
    Message ids are uuid4 (fresh every run), so keying jitter on them
    would make retry schedules unreproducible."""
    try:
        blob = json.dumps(msg.body, sort_keys=True)
    except (TypeError, ValueError):
        return str(msg.id)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


PAYLOAD_REGISTRY: Dict[str, Callable[[dict, "WorkerContext"], dict]] = {}


def register_payload(name: str):
    """Decorator: register a "Something" under ``name``."""

    def deco(fn):
        PAYLOAD_REGISTRY[name] = fn
        return fn

    return deco


@dataclass
class WorkerContext:
    """Everything a payload may touch, plus the heartbeat channel."""

    store: ObjectStore
    logs: LogGroup
    metrics: MetricRegistry
    clock: Clock
    task: TaskDefinition
    worker_id: str
    message: Optional[Message] = None
    queue: Optional[DurableQueue] = None
    # liveness wiring
    is_terminated: Callable[[], bool] = lambda: False
    on_heartbeat: Callable[[], None] = lambda: None
    # spot-revocation notice: True once the hosting instance has been
    # warned of termination — the payload should drain, not crash
    is_revoked: Callable[[], bool] = lambda: False
    # structured progress channel (autoscaler telemetry): payloads push
    # small dicts, the runner forwards them to the runtime's ProgressBoard
    on_progress: Callable[[dict], None] = lambda payload: None
    visibility: float = 120.0
    _last_extension: float = field(default=0.0)

    def heartbeat(self, progress: Optional[str] = None) -> None:
        """Payloads call this between units of work (e.g. every train step)."""
        if self.is_terminated():
            raise Preempted(f"instance hosting {self.worker_id} terminated")
        self.on_heartbeat()
        now = self.clock.now()
        # extend the lease when half the visibility window has elapsed
        if self.queue is not None and self.message is not None:
            if now - self._last_extension > self.visibility / 2:
                self.queue.change_visibility(self.message, self.visibility)
                self._last_extension = now
        if progress:
            self.logs.put(self.worker_id, progress)

    def revoked(self) -> bool:
        """True once the hosting instance holds a spot-revocation notice."""
        return self.is_revoked()

    def report_progress(self, payload: dict) -> None:
        """Publish a structured progress payload (autoscaler telemetry)."""
        self.on_progress(payload)

    def log(self, message: str, **fields) -> None:
        self.logs.put(self.worker_id, message, **fields)


def check_if_done(store: ObjectStore, td: TaskDefinition, output_prefix: str) -> bool:
    """The paper's done-check, verbatim semantics."""
    if not td.check_if_done:
        return False
    n = 0
    for info in store.list(output_prefix):
        if info.size < td.min_file_size_bytes:
            continue
        if td.necessary_string and td.necessary_string not in info.key:
            continue
        n += 1
    return n >= td.expected_number_files


class Worker:
    """One Docker-container-equivalent consuming jobs from the queue."""

    def __init__(
        self,
        worker_id: str,
        queue: DurableQueue,
        store: ObjectStore,
        logs: LogGroup,
        metrics: MetricRegistry,
        task: TaskDefinition,
        *,
        clock: Optional[Clock] = None,
        visibility: float = 120.0,
        empty_polls_before_shutdown: int = 3,
        is_terminated: Callable[[], bool] = lambda: False,
        on_heartbeat: Callable[[], None] = lambda: None,
        is_revoked: Callable[[], bool] = lambda: False,
        on_progress: Callable[[dict], None] = lambda payload: None,
        prefetch: int = 1,
    ):
        self.worker_id = worker_id
        self.queue = queue
        self.store = store
        self.logs = logs
        self.metrics = metrics
        self.task = task
        self.clock = clock or WallClock()
        self.visibility = visibility
        self.empty_polls_before_shutdown = empty_polls_before_shutdown
        self.is_terminated = is_terminated
        self.on_heartbeat = on_heartbeat
        self.is_revoked = is_revoked
        self.on_progress = on_progress
        # prefetch > 1: claim a batch of jobs in ONE queue transaction
        # (receive_batch) and drain it locally — high-fanout fleets stop
        # paying a lock + SQL round-trip per job.  Buffered jobs hold
        # their visibility lease; an unprocessed buffer simply resurfaces
        # after the timeout (at-least-once, same as a crashed worker).
        self.prefetch = max(1, int(prefetch))
        self._buffer: list = []
        self.jobs_done = 0
        self.jobs_failed = 0
        self.jobs_skipped = 0
        self.jobs_not_ready = 0
        self.jobs_yielded = 0
        # NotReady retries per message (keyed by id): release() refunds
        # receive_count, so the message's own counter cannot number the
        # attempts that exponential backoff needs
        self._notready_attempts: Dict[str, int] = {}

    # -- single-message processing (used by both runners) --------------------
    def process_one(self) -> Optional[str]:
        """Receive and process at most one message.

        Returns "done"/"skipped"/"failed"/"preempted" or ``None`` if the
        queue had no visible message.
        """
        if self.is_terminated():
            return "preempted"
        if not self._buffer:
            self._buffer = self.queue.receive_batch(self.prefetch, self.visibility)
        msg = self._buffer.pop(0) if self._buffer else None
        if msg is None:
            return None
        job = msg.body
        ctx = WorkerContext(
            store=self.store,
            logs=self.logs,
            metrics=self.metrics,
            clock=self.clock,
            task=self.task,
            worker_id=self.worker_id,
            message=msg,
            queue=self.queue,
            is_terminated=self.is_terminated,
            on_heartbeat=self.on_heartbeat,
            is_revoked=self.is_revoked,
            on_progress=self.on_progress,
            visibility=self.visibility,
        )
        ctx._last_extension = self.clock.now()
        output_prefix = job.get("output_prefix", "")
        try:
            if output_prefix and check_if_done(self.store, self.task, output_prefix):
                ctx.log(f"CHECK_IF_DONE: {output_prefix} already complete, skipping")
                self.queue.delete(msg)
                self.jobs_skipped += 1
                return "skipped"
            payload = PAYLOAD_REGISTRY.get(self.task.payload)
            if payload is None:
                raise KeyError(f"no payload registered under {self.task.payload!r}")
            if self.task.seconds_to_start:
                # SECONDS_TO_START: stagger copies to avoid memory spikes
                self.clock.sleep(self.task.seconds_to_start)
            result = payload(job, ctx)
            ctx.log("job complete", result=result)
            self.queue.delete(msg)
            self.jobs_done += 1
            self._notready_attempts.pop(msg.id, None)
            return "done"
        except Preempted:
            ctx.log("preempted mid-job; message will re-surface via visibility timeout")
            return "preempted"
        except LeaseYield as e:
            # a long-lived lease handing its slice back: release (budget
            # refunded — yielding is routine, not failure) and let the
            # fleet re-claim it.  No log line: slices recur every tick.
            self.queue.release(msg, e.retry_in)
            self.jobs_yielded += 1
            return "yielded"
        except NotReady as e:
            # capped exponential backoff + deterministic content-keyed
            # jitter: after a revocation requeues a herd of waiting jobs,
            # their retries spread out instead of hammering in lockstep
            attempt = self._notready_attempts.get(msg.id, 0) + 1
            self._notready_attempts[msg.id] = attempt
            delay = backoff_delay(
                e.retry_in, attempt, cap=self.visibility, key=_stable_key(msg)
            )
            ctx.log(
                f"job not ready ({e}); released for retry in {delay:.1f}s "
                f"(attempt {attempt})"
            )
            self.queue.release(msg, delay)
            self.jobs_not_ready += 1
            return "not_ready"
        except Exception as e:  # noqa: BLE001 - worker must survive payload bugs
            ctx.log(
                f"job failed (attempt {msg.receive_count}/{self.queue.max_receive_count}): {e}",
                traceback=traceback.format_exc(limit=20),
            )
            # fast-return with backoff: a failed job should not sit out its
            # full (long) processing lease — e.g. a step-span waiting on a
            # prerequisite checkpoint retries as earlier spans land.
            # Exponential in the receive count (the message's own attempt
            # number survives worker crashes), capped at the visibility,
            # jittered deterministically by content.
            backoff = backoff_delay(
                5.0, msg.receive_count, cap=self.visibility, key=_stable_key(msg)
            )
            self.queue.change_visibility(msg, backoff)
            self.jobs_failed += 1
            self._notready_attempts.pop(msg.id, None)
            return "failed"

    # -- the full loop (thread runner) ------------------------------------------
    def run(self, poll_interval: float = 0.05) -> None:
        empty = 0
        while not self.is_terminated():
            outcome = self.process_one()
            if outcome is None:
                empty += 1
                if empty >= self.empty_polls_before_shutdown:
                    # "If SQS tells them there are no visible jobs then they
                    # shut themselves down."
                    self.logs.put(self.worker_id, "queue empty; shutting down")
                    return
                self.clock.sleep(poll_interval)
            elif outcome == "preempted":
                return
            else:
                empty = 0
