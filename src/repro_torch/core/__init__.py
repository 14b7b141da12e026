"""repro_torch.core — the Distributed-Something control plane.

The port's own copy of the reference package's ``core/`` (framework-free;
the port imports nothing of the reference): durable queue with SQS
semantics, simulated spot fleet, ECS-style placement, CloudWatch-style
monitor, autoscaler, chaos drills, the generic worker template and the
four-command runtime.  Queue and store files are the reference's, so one
written by either package opens in the other.
"""

from .clock import Clock, VirtualClock, WallClock
from .cluster import ECSCluster, Service, Task, TaskDefinition
from .config import MACHINE_CATALOGUE, DSConfig, FleetFile, MachineType, load_config, load_fleet_file
from .fleet import Instance, InstanceState, SpotFleet, SpotMarket
from .jobs import JobFile, load_job_file, step_span_job_file
from .logs import LogGroup, MetricRegistry
from .monitor import Monitor, MonitorReport
from .queue import DurableQueue, Message
from .runtime import DSRuntime, RunSummary, SimRunner, ThreadRunner
from .storage import ObjectInfo, ObjectStore
from .worker import (PAYLOAD_REGISTRY, NotReady, Preempted, Worker, WorkerContext,
                     check_if_done, register_payload)
