"""The monitor — the paper's optional fourth command, plus the per-instance

The port's own copy of the reference package's ``core/monitor.py`` (the
port imports nothing of the reference), behaviour unchanged.

idle alarms that exist even without it.

Responsibilities (paper Step 4):

- poll the queue "once per minute" for visible/in-flight counts;
- evaluate idle alarms: an instance whose tasks have produced no heartbeat
  for ``idle_alarm_seconds`` ("CPU < 1% for 15 consecutive minutes, almost
  always the result of a crashed machine") is terminated and — in normal
  mode — replaced by the fleet's back-fill;
- hourly housekeeping: delete alarms of instances terminated in the last
  24 h (here: drop their liveness records);
- when the queue is fully drained (0 visible, 0 in-flight): downscale the
  ECS service, cancel the spot fleet, purge queues, export logs to the
  object store, and delete task definitions — the teardown sequence;
- "cheapest" mode: after a grace period, drop the fleet *target* to 1 and
  stop replacing terminated instances.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from .clock import Clock, WallClock
from .cluster import ECSCluster
from .config import DSConfig
from .fleet import InstanceState, SpotFleet
from .logs import LogGroup, MetricRegistry
from .queue import DurableQueue
from .storage import ObjectStore

CHEAPEST_GRACE_SECONDS = 15 * 60.0  # paper: downscale 15 min after engaged


@dataclass
class MonitorReport:
    time: float
    visible: int
    in_flight: int
    dead: int
    running_instances: int
    pending_instances: int
    idle_terminations: List[str] = field(default_factory=list)
    downscaled: bool = False
    finished: bool = False
    # chaos faults fired this poll ("kind:target") and the autoscaler's
    # applied target change (None = held / autoscaling off)
    chaos_events: List[str] = field(default_factory=list)
    autoscaled_to: Optional[int] = None


class Monitor:
    def __init__(
        self,
        cfg: DSConfig,
        queue: DurableQueue,
        fleet: SpotFleet,
        cluster: ECSCluster,
        logs: LogGroup,
        metrics: MetricRegistry,
        store: ObjectStore,
        *,
        clock: Optional[Clock] = None,
        cheapest: bool = False,
        autoscaler=None,
        chaos=None,
    ):
        self.cfg = cfg
        self.queue = queue
        self.fleet = fleet
        self.cluster = cluster
        self.logs = logs
        self.metrics = metrics
        self.store = store
        self.clock = clock or WallClock()
        self.cheapest = cheapest
        self.autoscaler = autoscaler
        self.chaos = chaos
        self.started_at = self.clock.now()
        self.finished = False
        self._cheapest_applied = False
        self._last_hourly = self.started_at
        self._alarm_records: dict = {}
        self.history: List[MonitorReport] = []

    # ------------------------------------------------------------------ tick
    def tick(self) -> MonitorReport:
        """One monitor poll (the paper's once-per-minute check)."""
        now = self.clock.now()
        # fire scheduled chaos first: a fault injected this poll must be
        # visible to the idle alarms / autoscaler evaluated below, same
        # as one that happened between polls
        if self.chaos is not None:
            report_chaos = [
                f"{r.kind}:{r.target}" for r in self.chaos.tick()
            ]
        else:
            report_chaos = []
        counts = self.queue.counts()
        report = MonitorReport(
            time=now,
            visible=counts["visible"],
            in_flight=counts["in_flight"],
            dead=counts["dead"],
            running_instances=len(self.fleet.running()),
            pending_instances=len(self.fleet.pending()),
            chaos_events=report_chaos,
        )

        # -- idle alarms -----------------------------------------------------
        for inst in self.fleet.running():
            idle_for = now - max(inst.last_heartbeat, inst.ready_time)
            if idle_for >= self.cfg.idle_alarm_seconds:
                self.fleet.terminate_instance(inst.id, reason="idle-alarm")
                self.logs.put(
                    "monitor",
                    f"idle alarm fired for {inst.id} (idle {idle_for:.0f}s); terminated",
                )
                report.idle_terminations.append(inst.id)
        self.cluster.reap_dead_tasks(self.fleet)

        # -- hourly housekeeping ------------------------------------------------
        if now - self._last_hourly >= 3600.0:
            cutoff = now - 24 * 3600.0
            for iid, inst in list(self.fleet.instances.items()):
                if (
                    inst.state == InstanceState.TERMINATED
                    and inst.terminate_time is not None
                    and inst.terminate_time >= cutoff
                ):
                    self._alarm_records.pop(iid, None)
            self._last_hourly = now

        # -- cheapest mode -------------------------------------------------------
        if (
            self.cheapest
            and not self._cheapest_applied
            and now - self.started_at >= CHEAPEST_GRACE_SECONDS
        ):
            self.fleet.modify_target(min(self.fleet.target_capacity, 1))
            self.fleet.replace_on_terminate = False
            self._cheapest_applied = True
            self.logs.put("monitor", "cheapest mode: fleet target downscaled to 1")

        # -- autoscaling ---------------------------------------------------------
        if self.autoscaler is not None and not self.finished:
            decision = self.autoscaler.tick()
            if decision is not None and decision.applied:
                report.autoscaled_to = decision.desired

        # -- teardown when drained --------------------------------------------------
        if counts["visible"] == 0 and counts["in_flight"] == 0 and not self.finished:
            self._teardown()
            report.downscaled = True
            report.finished = True

        self.metrics.gauge("queue.visible", counts["visible"])
        self.metrics.gauge("queue.in_flight", counts["in_flight"])
        self.metrics.gauge("fleet.running", report.running_instances)
        self.history.append(report)
        return report

    def run(self, max_ticks: int = 10_000) -> MonitorReport:
        """Poll until drained (tick cadence = ``monitor_poll_seconds``)."""
        report = self.tick()
        ticks = 1
        while not report.finished and ticks < max_ticks:
            self.clock.sleep(self.cfg.monitor_poll_seconds)
            report = self.tick()
            ticks += 1
        return report

    # ------------------------------------------------------------------ teardown
    def _sweep_queue(self) -> int:
        """Batched straggler sweep: messages that became visible between
        the drain check and teardown (e.g. a preempted worker's lease
        expiring mid-poll) are claimed with ``receive_batch`` and
        acknowledged with ``delete_batch`` — one transaction per batch
        instead of a lock + SQL round-trip per message — so their ids are
        logged before the final purge wipes the tables."""
        swept = 0
        while True:
            batch = self.queue.receive_batch(32)
            if not batch:
                break
            for m in batch:
                self.logs.put(
                    "monitor", f"teardown sweep: acked straggler {m.id}"
                )
            swept += self.queue.delete_batch(batch)
        return swept

    def _sweep_kvprefix(self) -> int:
        """TTL-sweep the cross-host KV prefix pages (``kvprefix/``) when
        the config opts in: without it the content-addressed store grows
        across runs until an operator sweeps by hand.  Pages are
        immutable and re-publishable, so expiry is always safe; workers
        racing the sweep see a plain fetch miss.

        The port has no prefix store yet (ROADMAP Queue 1), so the sweep
        is the reference's ``PrefixStore.sweep`` written out over the
        store: pages under ``kvprefix/`` older than the TTL (by object
        mtime, wall clock) are deleted unless a fresh pin marker under
        ``kvprefix-pins/`` names them; expired markers go too and are not
        counted.  A store shared with the reference package is swept the
        same way."""
        ttl = getattr(self.cfg, "kvprefix_ttl_seconds", None)
        if ttl is None:
            return 0
        ttl, now = float(ttl), time.time()
        pinned = set()
        for info in list(self.store.list("kvprefix-pins/")):
            if now - info.mtime < ttl:
                pinned.add(info.key.rsplit("/", 1)[-1])
            else:
                self.store.delete(info.key)
        swept = 0
        for info in list(self.store.list("kvprefix/")):
            if info.key.rsplit("/", 1)[-1] in pinned:
                continue
            if now - info.mtime >= ttl:
                self.store.delete(info.key)
                swept += 1
        return swept

    def _teardown(self) -> None:
        svc_name = f"{self.cfg.app_name}Service"
        if svc_name in self.cluster.services:
            self.cluster.update_desired_count(svc_name, 0)
            self.cluster.deregister_service(svc_name)
        self.fleet.cancel(terminate_instances=True)
        self.cluster.reap_dead_tasks(self.fleet)
        swept = self._sweep_queue()
        if swept:
            self.logs.put("monitor", f"teardown sweep acked {swept} stragglers")
        pages = self._sweep_kvprefix()
        if pages:
            self.logs.put(
                "monitor", f"teardown sweep deleted {pages} expired kvprefix pages"
            )
        self.queue.purge()  # in-flight remnants + dead letters
        n = self.logs.export(self.store, f"logs/{self.cfg.app_name}")
        self.logs.put("monitor", f"teardown complete; exported {n} log streams")
        self.finished = True
