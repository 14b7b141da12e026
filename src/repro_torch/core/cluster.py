"""ECS analogue: task definitions, services, and container placement.

The port's own copy of the reference package's ``core/cluster.py`` (the
port imports nothing of the reference), behaviour unchanged.

The paper's behaviours reproduced here:

- a *task definition* encodes the container's resource envelope
  (CPU_SHARES, MEMORY) and run settings (CHECK_IF_DONE, DOCKER_CORES, ...);
- a *service* says how many copies you want (CLUSTER_MACHINES ×
  TASKS_PER_MACHINE);
- placement bin-packs tasks onto instances **by resources**: a task larger
  than the instance never places, and an instance bigger than intended
  will take more tasks than you meant ("ECS will keep placing Dockers onto
  an instance until it is full") — both are reproduced and unit-tested;
- when a container is placed it names its instance after the app
  (paper Step 3, automatic actions 1–2).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List

from .config import DSConfig
from .fleet import Instance, InstanceState, SpotFleet


@dataclass
class TaskDefinition:
    family: str
    payload: str
    cpu_shares: int  # 1024 == 1 vCPU
    memory_mb: int
    docker_cores: int
    env: Dict[str, str] = field(default_factory=dict)
    check_if_done: bool = True
    expected_number_files: int = 1
    min_file_size_bytes: int = 1
    necessary_string: str = ""
    seconds_to_start: float = 0.0

    @classmethod
    def from_config(cls, cfg: DSConfig) -> "TaskDefinition":
        return cls(
            family=f"{cfg.app_name}Task",
            payload=cfg.payload,
            cpu_shares=cfg.cpu_shares,
            memory_mb=cfg.memory_mb,
            docker_cores=cfg.docker_cores,
            env=dict(cfg.env),
            check_if_done=cfg.check_if_done,
            expected_number_files=cfg.expected_number_files,
            min_file_size_bytes=cfg.min_file_size_bytes,
            necessary_string=cfg.necessary_string,
            seconds_to_start=cfg.seconds_to_start,
        )


@dataclass
class Task:
    id: str
    definition: TaskDefinition
    instance_id: str
    started_at: float


@dataclass
class Service:
    name: str
    task_definition: TaskDefinition
    desired_count: int


class ECSCluster:
    """Tracks services and places tasks onto fleet instances."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.services: Dict[str, Service] = {}
        self.tasks: Dict[str, Task] = {}
        self._ids = itertools.count()

    # -- control-plane ops ---------------------------------------------------
    def register_service(self, service: Service) -> None:
        self.services[service.name] = service

    def update_desired_count(self, service_name: str, count: int) -> None:
        self.services[service_name].desired_count = int(count)

    def deregister_service(self, service_name: str) -> None:
        # match tasks by the service's task definition: the definition
        # family is "<app>Task" while the service is "<app>Service", so
        # the old family.startswith(service_name) check never fired and
        # task records leaked past teardown
        svc = self.services.pop(service_name, None)
        if svc is None:
            return
        for tid in [t for t, task in self.tasks.items()
                    if task.definition == svc.task_definition]:
            self.tasks.pop(tid, None)

    # -- placement -------------------------------------------------------------
    def _fits(self, td: TaskDefinition, inst: Instance) -> bool:
        used_cpu = sum(self.tasks[t].definition.cpu_shares for t in inst.tasks if t in self.tasks)
        used_mem = sum(self.tasks[t].definition.memory_mb for t in inst.tasks if t in self.tasks)
        cap_cpu = inst.machine_type.vcpus * 1024
        cap_mem = inst.machine_type.memory_mb
        return used_cpu + td.cpu_shares <= cap_cpu and used_mem + td.memory_mb <= cap_mem

    def place(self, service_name: str, fleet: SpotFleet, now: float) -> List[Task]:
        """Place tasks for ``service`` until desired_count is met or no
        instance has room.  Returns newly placed tasks."""
        svc = self.services[service_name]
        live = {t: task for t, task in self.tasks.items()}
        current = [
            t
            for t, task in live.items()
            # equality, not identity: a re-registered service (same config,
            # new TaskDefinition object) must still count its live tasks
            # or placement doubles up
            if task.definition == svc.task_definition
            and fleet.instances.get(task.instance_id) is not None
            and fleet.instances[task.instance_id].state == InstanceState.RUNNING
        ]
        placed: List[Task] = []
        deficit = svc.desired_count - len(current)
        if deficit <= 0:
            return placed
        for inst in fleet.running():
            while deficit > 0 and self._fits(svc.task_definition, inst):
                tid = f"task-{next(self._ids):06d}"
                task = Task(id=tid, definition=svc.task_definition, instance_id=inst.id, started_at=now)
                self.tasks[tid] = task
                inst.tasks.append(tid)
                if not inst.name:
                    # "When a Docker container gets placed it gives the
                    # instance it's on its own name."
                    inst.name = f"{svc.name}-{inst.id}"
                placed.append(task)
                deficit -= 1
            if deficit <= 0:
                break
        return placed

    def reap_dead_tasks(self, fleet: SpotFleet) -> List[Task]:
        """Drop tasks whose instance has terminated; their in-flight jobs
        resurface via the queue's visibility timeout."""
        dead = []
        for tid, task in list(self.tasks.items()):
            inst = fleet.instances.get(task.instance_id)
            if inst is None or inst.state == InstanceState.TERMINATED:
                dead.append(self.tasks.pop(tid))
        return dead
