"""DS run configuration — the paper's ``config.py`` as a typed dataclass.

The port's own copy of the reference package's ``core/config.py`` (the
port imports nothing of the reference), behaviour unchanged.

Field names deliberately mirror the paper's Online Methods (Step 1:
Configuration) so anybody who has operated Distributed-CellProfiler /
-Fiji / -OmeZarrCreator can read a run config here unchanged.  Fields
that are AWS-billing specific keep their semantics under the simulated
spot market (``machine_price`` is the bid; the market can out-price you).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class MachineType:
    """Catalogue entry for an instance type (the EC2 analogue)."""

    name: str
    vcpus: int
    memory_mb: int
    # simulated spot market properties
    on_demand_price: float = 1.0
    # TPU-adaptation: chips attached to this worker (a pod-slice size)
    chips: int = 0


# A small instance catalogue; examples/tests reference these by name.
MACHINE_CATALOGUE: Dict[str, MachineType] = {
    m.name: m
    for m in [
        MachineType("sim.small", vcpus=2, memory_mb=4096, on_demand_price=0.10),
        MachineType("sim.large", vcpus=8, memory_mb=16384, on_demand_price=0.40),
        MachineType("sim.xlarge", vcpus=16, memory_mb=65536, on_demand_price=1.60),
        MachineType("tpu.v5e-8", vcpus=8, memory_mb=65536, on_demand_price=4.0, chips=8),
        MachineType("tpu.v5e-256", vcpus=32, memory_mb=131072, on_demand_price=128.0, chips=256),
    ]
}


# Paper-fidelity knobs deliberately carried on DSConfig without a
# consumer in the simulation.  dslint R7 requires every field to be
# either consumed somewhere under src/repro/ or *refused* here with a
# written reason — an operator tuning an inert knob must be able to
# find out why it does nothing.  Wire a field up -> delete its entry.
INERT_PAPER_FIELDS: Dict[str, str] = {
    "ebs_vol_size_gb": (
        "paper Step-1 EC2 knob kept for config-file parity; the "
        "simulation has no block devices to size — only the paper's "
        "minimum-size validation (>= 22 GB) is enforced"
    ),
    "sqs_dead_letter_queue": (
        "paper names a separate SQS queue; the simulated DurableQueue "
        "keeps dead letters in an in-queue table instead (see "
        "core/queue.py), so the name is never dereferenced — kept so "
        "paper-shaped config files round-trip"
    ),
}


@dataclass
class DSConfig:
    """One Distributed-Something run (paper Step 1)."""

    # -- identity ---------------------------------------------------------
    app_name: str = "DistributedSomething"
    payload: str = "distributed-train"  # DOCKERHUB_TAG analogue: registered payload id

    # -- EC2/ECS ----------------------------------------------------------
    ecs_cluster: str = "default"
    cluster_machines: int = 4  # CLUSTER_MACHINES
    tasks_per_machine: int = 1  # TASKS_PER_MACHINE
    machine_type: List[str] = field(default_factory=lambda: ["sim.large"])
    machine_price: float = 0.5  # spot bid, $/hr
    ebs_vol_size_gb: int = 22

    # -- docker runtime ----------------------------------------------------
    docker_cores: int = 1  # copies of the script per container
    cpu_shares: int = 4096  # 1024 == 1 vCPU, ECS convention
    memory_mb: int = 8192
    seconds_to_start: float = 0.0

    # -- SQS ---------------------------------------------------------------
    sqs_queue_name: str = "DistributedSomethingQueue"
    sqs_message_visibility: float = 120.0
    sqs_dead_letter_queue: str = "DistributedSomethingDeadLetters"
    max_receive_count: int = 3

    # -- CloudWatch ---------------------------------------------------------
    log_group_name: str = "DistributedSomething"
    # idle alarm: terminate instances idle longer than this (paper: CPU<1%
    # for 15 consecutive minutes)
    idle_alarm_seconds: float = 15 * 60.0
    monitor_poll_seconds: float = 60.0
    # TTL (seconds, by object mtime) for cross-host KV prefix pages under
    # kvprefix/: the monitor sweeps expired pages at teardown.  None
    # disables the sweep (pages persist across runs); 0 clears the prefix
    kvprefix_ttl_seconds: Optional[float] = None
    # -- serving fleet defaults ---------------------------------------------
    # speculative decoding for distributed-serve fleets: "off", "ngram"
    # (prompt-lookup drafts from each request's own history) or "draft"
    # (a small draft model with its own paged cache).  These are the
    # fleet-level defaults operators copy into serve job templates (the
    # job dict's "speculative"/"spec_k" keys override per job); greedy
    # output is byte-identical either way, only tokens/dispatch changes
    speculative: str = "off"
    spec_k: int = 4
    # disaggregated serving role for distributed-serve fleets: "unified"
    # (the monolith — every worker prefills and decodes), "prefill"
    # (workers only ingest prompts, publish the full prompt's KV through
    # the prefix store and enqueue a sealed handoff record onto the
    # decode queue) or "decode" (workers lease handoff records, hydrate
    # the published pages on demand and run pure decode ticks).  Like
    # speculative/spec_k this is the fleet-level default operators copy
    # into serve job templates (the job dict's "worker_role" key is what
    # serve.py reads per job); split fleets need a "decode_queue" in the
    # job as well.  See docs/serving.md "Disaggregated prefill/decode".
    worker_role: str = "unified"
    # -- autoscaling ---------------------------------------------------------
    # "off" (static fleet, the paper's behaviour), "queue" (size to the
    # reported request-queue backlog) or "slo" (queue policy plus scale-up
    # on p99 TTFT breaches).  See core/autoscaler.py for the policy and
    # docs/serving.md for operator guidance.  min/max_workers bound the
    # fleet target; target p99 is in engine ticks (the unit serve leases
    # report); cooldowns are (virtual) seconds; max_step bounds how far
    # one decision may move the target.
    autoscale: str = "off"
    min_workers: int = 1
    max_workers: int = 8
    autoscale_queue_per_worker: int = 4
    autoscale_target_p99_ttft: float = 0.0
    autoscale_up_cooldown_seconds: float = 60.0
    autoscale_down_cooldown_seconds: float = 600.0
    autoscale_max_step: int = 2

    # -- idempotent restart (CHECK_IF_DONE) ----------------------------------
    check_if_done: bool = True  # CHECK_IF_DONE_BOOL
    expected_number_files: int = 1  # EXPECTED_NUMBER_FILES
    min_file_size_bytes: int = 1  # MIN_FILE_SIZE_BYTES
    necessary_string: str = ""  # NECESSARY_STRING

    # -- extra environment passed to the payload ("VARIABLE" in the paper) ---
    env: Dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------------ io
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "DSConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown DSConfig fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "DSConfig":
        return cls.from_dict(json.loads(text))

    def validate(self) -> None:
        if self.cluster_machines < 0:
            raise ValueError("cluster_machines must be >= 0")
        if self.tasks_per_machine < 1:
            raise ValueError("tasks_per_machine must be >= 1")
        for mt in self.machine_type:
            if mt not in MACHINE_CATALOGUE:
                raise ValueError(f"unknown machine type {mt!r}")
        if self.sqs_message_visibility <= 0:
            raise ValueError("sqs_message_visibility must be > 0")
        if self.ebs_vol_size_gb < 22:
            raise ValueError("ebs_vol_size_gb minimum allowed is 22")  # paper
        if self.speculative not in ("off", "ngram", "draft"):
            raise ValueError(
                f"speculative must be off|ngram|draft, got {self.speculative!r}"
            )
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.worker_role not in ("unified", "prefill", "decode"):
            raise ValueError(
                "worker_role must be unified|prefill|decode, "
                f"got {self.worker_role!r}"
            )
        if self.autoscale not in ("off", "queue", "slo"):
            raise ValueError(
                f"autoscale must be off|queue|slo, got {self.autoscale!r}"
            )
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.autoscale_queue_per_worker < 1:
            raise ValueError("autoscale_queue_per_worker must be >= 1")
        if self.autoscale_max_step < 1:
            raise ValueError("autoscale_max_step must be >= 1")
        if (self.autoscale_up_cooldown_seconds < 0
                or self.autoscale_down_cooldown_seconds < 0):
            raise ValueError("autoscale cooldowns must be >= 0")
        if self.autoscale == "slo" and self.autoscale_target_p99_ttft <= 0:
            raise ValueError(
                "autoscale='slo' needs autoscale_target_p99_ttft > 0"
            )


@dataclass
class FleetFile:
    """Account-specific spot-fleet request (paper Step 3).

    The AWS-credential-shaped fields exist so the operator workflow
    matches the paper; the simulated market only uses the market fields.
    """

    iam_fleet_role: str = "arn:sim:iam::role/aws-ec2-spot-fleet-tagging-role"
    iam_instance_profile: str = "arn:sim:iam::instance-profile/ecsInstanceRole"
    key_name: str = "ds-key"
    subnet_id: str = "subnet-sim"
    security_groups: List[str] = field(default_factory=lambda: ["sg-sim"])
    image_id: str = "ami-ecs-optimized-sim"
    snapshot_id: str = "snap-sim"
    region: str = "us-sim-1"
    # market simulation knobs
    market_seed: int = 0
    preemption_rate_per_hour: float = 0.0  # per-instance
    capacity: int = 10_000
    startup_seconds: float = 5.0
    price_volatility: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FleetFile":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FleetFile fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "FleetFile":
        return cls.from_dict(json.loads(text))


def load_config(path: str) -> DSConfig:
    with open(path) as f:
        cfg = DSConfig.from_json(f.read())
    cfg.validate()
    return cfg


def load_fleet_file(path: str) -> FleetFile:
    with open(path) as f:
        return FleetFile.from_json(f.read())
