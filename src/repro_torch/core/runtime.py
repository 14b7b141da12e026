"""DSRuntime — wires queue/fleet/cluster/monitor/workers into the paper's

The port's own copy of the reference package's ``core/runtime.py`` (the
port imports nothing of the reference), behaviour unchanged.

four-command lifecycle, with two execution backends:

- :class:`SimRunner` — deterministic, tick-driven, virtual-clock execution
  used by tests and benchmarks to exercise control-plane semantics
  (preemption, stragglers, autoscaling, DLQ) reproducibly;
- :class:`ThreadRunner` — real threads + wall clock, used by the examples
  to actually parallelize JAX work across local workers.

The lifecycle mirrors the paper exactly:

    rt = DSRuntime(cfg, store_root=...)
    rt.setup()                      # python run.py setup
    rt.submit_job(job_file)         # python run.py submitJob files/job.json
    rt.start_cluster(fleet_file)    # python run.py startCluster files/fleet.json
    rt.run_monitor()                # python run.py monitor <app>SpotFleetRequestId.json
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from .autoscaler import Autoscaler, ProgressBoard
from .clock import Clock, VirtualClock, WallClock
from .cluster import ECSCluster, Service, TaskDefinition
from .config import DSConfig, FleetFile
from .fleet import SpotFleet
from .jobs import JobFile
from .logs import LogGroup, MetricRegistry
from .monitor import Monitor
from .queue import DurableQueue
from .storage import ObjectStore
from .worker import Worker


@dataclass
class RunSummary:
    jobs_done: int
    jobs_skipped: int
    jobs_failed: int
    dead_letters: int
    preemptions: int
    idle_terminations: int
    ticks: int
    wall_time: float


class DSRuntime:
    def __init__(
        self,
        cfg: DSConfig,
        *,
        store_root: str,
        clock: Optional[Clock] = None,
        workdir: Optional[str] = None,
    ):
        cfg.validate()
        self.cfg = cfg
        self.clock = clock or WallClock()
        self.store = ObjectStore(store_root)
        self.workdir = workdir or os.path.join(store_root, "_runtime")
        os.makedirs(self.workdir, exist_ok=True)
        self.logs = LogGroup(cfg.log_group_name, clock=self.clock)
        self.metrics = MetricRegistry(clock=self.clock)
        self.queue: Optional[DurableQueue] = None
        self.cluster = ECSCluster(cfg.ecs_cluster)
        self.fleet: Optional[SpotFleet] = None
        self.task_definition: Optional[TaskDefinition] = None
        self.monitor: Optional[Monitor] = None
        # latest heartbeat progress payload per worker (autoscaler input)
        self.progress_board = ProgressBoard()
        self.autoscaler: Optional[Autoscaler] = None
        self._submitted = 0

    # ------------------------------------------------------------ step 1: setup
    def setup(self) -> None:
        """Create task definition, queue (+DLQ), and the ECS service."""
        self.task_definition = TaskDefinition.from_config(self.cfg)
        self.queue = DurableQueue(
            os.path.join(self.workdir, f"{self.cfg.sqs_queue_name}.sqlite"),
            default_visibility=self.cfg.sqs_message_visibility,
            max_receive_count=self.cfg.max_receive_count,
            clock=self.clock,
        )
        self.cluster.register_service(
            Service(
                name=f"{self.cfg.app_name}Service",
                task_definition=self.task_definition,
                desired_count=self.cfg.cluster_machines * self.cfg.tasks_per_machine,
            )
        )
        self.logs.put("runtime", "setup complete: task definition + queue + service")

    # -------------------------------------------------------- step 2: submitJob
    def submit_job(self, job_file: JobFile) -> int:
        if self.queue is None:
            raise RuntimeError("call setup() before submit_job()")
        bodies = job_file.expand()
        self.queue.send_batch(bodies)
        self._submitted += len(bodies)
        self.logs.put("runtime", f"submitted {len(bodies)} jobs")
        return len(bodies)

    # ------------------------------------------------------ step 3: startCluster
    def start_cluster(self, fleet_file: FleetFile) -> str:
        self.fleet = SpotFleet(fleet_file, clock=self.clock, app_name=self.cfg.app_name)
        request_id = self.fleet.request(
            target_capacity=self.cfg.cluster_machines,
            bid=self.cfg.machine_price,
            machine_types=self.cfg.machine_type,
        )
        # DS drops <APP_NAME>SpotFleetRequestId.json for the monitor
        self.store.put_json(
            f"{self.cfg.app_name}SpotFleetRequestId.json",
            {"request_id": request_id, "app_name": self.cfg.app_name},
        )
        self.logs.put("runtime", f"spot fleet requested: {request_id}")
        return request_id

    # ---------------------------------------------------------- step 4: monitor
    def make_monitor(self, cheapest: bool = False, chaos=None) -> Monitor:
        if self.queue is None or self.fleet is None:
            raise RuntimeError("setup() and start_cluster() must run first")
        if self.cfg.autoscale != "off":
            self.autoscaler = Autoscaler(
                self.cfg,
                self.queue,
                self.fleet,
                self.cluster,
                clock=self.clock,
                logs=self.logs,
                board=self.progress_board,
            )
        self.monitor = Monitor(
            self.cfg,
            self.queue,
            self.fleet,
            self.cluster,
            self.logs,
            self.metrics,
            self.store,
            clock=self.clock,
            cheapest=cheapest,
            autoscaler=self.autoscaler,
            chaos=chaos,
        )
        return self.monitor


class SimRunner:
    """Deterministic tick-driven execution of a DSRuntime.

    Each tick: advance the market, place tasks, let every placed task
    process at most one message (heartbeating through the virtual clock),
    then run a monitor poll.  Preemption/straggler behaviour is exact and
    reproducible given the fleet-file seed.
    """

    def __init__(
        self,
        rt: DSRuntime,
        *,
        tick_seconds: float = 60.0,
        cheapest: bool = False,
        prefetch: int = 1,
        chaos=None,
        on_tick=None,
    ):
        if not isinstance(rt.clock, VirtualClock):
            raise TypeError("SimRunner requires a VirtualClock runtime")
        self.rt = rt
        self.tick_seconds = tick_seconds
        # chaos: a ChaosMonkey whose time-triggered faults fire from the
        # monitor poll and whose beat-triggered faults fire from the
        # heartbeat path (mid-payload).  on_tick(tick_number): a hook
        # called at the top of every tick — benchmarks inject request
        # arrivals through it without subclassing the runner.
        self.chaos = chaos
        self.on_tick = on_tick
        self.monitor = rt.make_monitor(cheapest=cheapest, chaos=chaos)
        self._workers: Dict[str, Worker] = {}
        self.preemptions = 0
        # prefetch > 1: workers claim job batches in ONE queue transaction
        # (DurableQueue.receive_batch) and drain the buffer across ticks.
        # Keep prefetch * tick_seconds below the visibility timeout or
        # buffered jobs get re-delivered (at-least-once, so still correct,
        # just wasteful).
        self.prefetch = max(1, int(prefetch))

    def _worker_for_task(self, task_id: str, instance_id: str) -> Worker:
        if task_id not in self._workers:
            fleet = self.rt.fleet
            inst = fleet.instances[instance_id]

            def is_terminated(inst=inst):
                return inst.state.value == "terminated"

            def on_heartbeat(inst=inst):
                # a delay_heartbeat fault suppresses the liveness record
                # (the idle alarm then sees a silent host); beat-triggered
                # faults fire here so a kill can land mid-slice
                ch = self.chaos
                if ch is None or ch.allow_heartbeat(inst):
                    inst.last_heartbeat = self.rt.clock.now()
                if ch is not None:
                    ch.on_beat(inst)

            def is_revoked(inst=inst):
                return inst.revoke_at is not None

            worker_id = f"{instance_id}/{task_id}"

            def on_progress(payload, wid=worker_id):
                self.rt.progress_board.put(wid, payload, self.rt.clock.now())

            self._workers[task_id] = Worker(
                worker_id=worker_id,
                queue=self.rt.queue,
                store=self.rt.store,
                logs=self.rt.logs,
                metrics=self.rt.metrics,
                task=self.rt.task_definition,
                clock=self.rt.clock,
                visibility=self.rt.cfg.sqs_message_visibility,
                is_terminated=is_terminated,
                on_heartbeat=on_heartbeat,
                is_revoked=is_revoked,
                on_progress=on_progress,
                prefetch=self.prefetch,
            )
        return self._workers[task_id]

    def run(self, max_ticks: int = 10_000) -> RunSummary:
        rt = self.rt
        start = rt.clock.now()
        ticks = 0
        idle_terms = 0
        while ticks < max_ticks:
            ticks += 1
            if self.on_tick is not None:
                self.on_tick(ticks)
            terminated = rt.fleet.tick()
            self.preemptions += sum(
                1 for i in terminated
                if i.terminate_reason in (
                    "spot-preemption", "price-above-bid",
                    "spot-revocation", "chaos-kill",
                )
            )
            rt.cluster.reap_dead_tasks(rt.fleet)
            placed = rt.cluster.place(f"{rt.cfg.app_name}Service", rt.fleet, rt.clock.now())
            del placed
            # every live task processes at most one message this tick
            for tid, task in list(rt.cluster.tasks.items()):
                inst = rt.fleet.instances.get(task.instance_id)
                if inst is None or inst.state.value != "running":
                    continue
                worker = self._worker_for_task(tid, task.instance_id)
                for _ in range(rt.task_definition.docker_cores):
                    outcome = worker.process_one()
                    # "yielded" ends the tick for this worker too: a lease
                    # slice is a full tick's budget — re-claiming it in the
                    # same tick would let one worker starve the others
                    if outcome in (None, "preempted", "yielded"):
                        break
            report = self.monitor.tick()
            idle_terms += len(report.idle_terminations)
            if report.finished:
                break
            rt.clock.sleep(self.tick_seconds)
        done = sum(w.jobs_done for w in self._workers.values())
        skipped = sum(w.jobs_skipped for w in self._workers.values())
        failed = sum(w.jobs_failed for w in self._workers.values())
        return RunSummary(
            jobs_done=done,
            jobs_skipped=skipped,
            jobs_failed=failed,
            dead_letters=len(self.rt.queue.dead_letters()) if not self.monitor.finished else 0,
            preemptions=self.preemptions,
            idle_terminations=idle_terms,
            ticks=ticks,
            wall_time=rt.clock.now() - start,
        )


class ThreadRunner:
    """Real-thread execution: one thread per (machine × tasks_per_machine).

    Used by the examples to run actual JAX training jobs in parallel on
    the local host.  Fleet semantics (startup delay, preemption) still
    apply through the shared clock.
    """

    def __init__(self, rt: DSRuntime, *, cheapest: bool = False, prefetch: int = 1):
        self.rt = rt
        self.monitor = rt.make_monitor(cheapest=cheapest)
        self.threads: List[threading.Thread] = []
        self.workers: List[Worker] = []
        self.prefetch = max(1, int(prefetch))

    def _spawn(self, tid: str, poll_interval: float) -> None:
        rt = self.rt
        task = rt.cluster.tasks[tid]
        inst = rt.fleet.instances[task.instance_id]

        def is_terminated(inst=inst):
            return inst.state.value == "terminated"

        def on_heartbeat(inst=inst):
            inst.last_heartbeat = rt.clock.now()

        def is_revoked(inst=inst):
            return inst.revoke_at is not None

        worker_id = f"{inst.id}/{tid}"

        def on_progress(payload, wid=worker_id):
            rt.progress_board.put(wid, payload, rt.clock.now())

        worker = Worker(
            worker_id=worker_id,
            queue=rt.queue,
            store=rt.store,
            logs=rt.logs,
            metrics=rt.metrics,
            task=rt.task_definition,
            clock=rt.clock,
            visibility=rt.cfg.sqs_message_visibility,
            is_terminated=is_terminated,
            on_heartbeat=on_heartbeat,
            is_revoked=is_revoked,
            on_progress=on_progress,
            prefetch=self.prefetch,
        )
        self.workers.append(worker)
        t = threading.Thread(target=worker.run, args=(poll_interval,), daemon=True)
        self._threads_by_task[tid] = t
        self.threads.append(t)
        t.start()

    def run(self, poll_interval: float = 0.02, monitor_interval: float = 0.05) -> RunSummary:
        rt = self.rt
        start = rt.clock.now()
        self._threads_by_task: Dict[str, threading.Thread] = {}
        rt.fleet.tick()
        # wait for initial capacity
        while not rt.fleet.running():
            rt.clock.sleep(0.05)
            rt.fleet.tick()

        # monitor loop on this thread; placement + worker (re)spawn are part
        # of it so replacement instances get workers and workers that shut
        # down while a retried job was invisible are restarted
        ticks = 0
        idle_terms = 0
        while True:
            ticks += 1
            rt.fleet.tick()
            rt.cluster.reap_dead_tasks(rt.fleet)
            rt.cluster.place(f"{rt.cfg.app_name}Service", rt.fleet, rt.clock.now())
            counts = rt.queue.counts()
            for tid, task in list(rt.cluster.tasks.items()):
                inst = rt.fleet.instances.get(task.instance_id)
                if inst is None or inst.state.value != "running":
                    continue
                th = self._threads_by_task.get(tid)
                if th is None or (not th.is_alive() and counts["visible"] > 0):
                    self._spawn(tid, poll_interval)
            report = self.monitor.tick()
            idle_terms += len(report.idle_terminations)
            if report.finished:
                break
            rt.clock.sleep(monitor_interval)
        for t in self.threads:
            t.join(timeout=30.0)
        return RunSummary(
            jobs_done=sum(w.jobs_done for w in self.workers),
            jobs_skipped=sum(w.jobs_skipped for w in self.workers),
            jobs_failed=sum(w.jobs_failed for w in self.workers),
            dead_letters=0,
            preemptions=0,
            idle_terminations=idle_terms,
            ticks=ticks,
            wall_time=rt.clock.now() - start,
        )
