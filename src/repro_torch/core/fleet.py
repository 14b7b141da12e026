"""Spot fleet — elastic, preemptible capacity (the paper's EC2 spot fleet).

The port's own copy of the reference package's ``core/fleet.py`` (the
port imports nothing of the reference), behaviour unchanged.

The fleet request has a *target capacity* and a *bid*; the market decides
what you actually get and may take instances back at any time.  The paper
leans on three behaviours we reproduce faithfully:

1. capacity arrives asynchronously ("a couple of minutes to several
   hours"), so submission and execution are decoupled via the queue;
2. any instance can be preempted mid-job ("spot prices rising above your
   maximum bid, machine crashes, etc."); recovery is the queue's
   visibility timeout, not fleet-level state;
3. the monitor replaces crashed/idle instances unless "cheapest" mode.

The market is deterministic given a seed, so node-failure tests are
reproducible.  Preemption draws use an exponential inter-arrival model
per instance (rate = ``preemption_rate_per_hour``).
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from .clock import Clock, WallClock
from .config import MACHINE_CATALOGUE, FleetFile, MachineType


class InstanceState(str, Enum):
    PENDING = "pending"
    RUNNING = "running"
    TERMINATED = "terminated"


@dataclass
class Instance:
    id: str
    machine_type: MachineType
    state: InstanceState
    launch_time: float
    ready_time: float  # when it transitions PENDING -> RUNNING
    terminate_time: Optional[float] = None
    terminate_reason: str = ""
    # ECS bookkeeping: task ids placed on this instance
    tasks: List[str] = field(default_factory=list)
    # liveness: last heartbeat from any task on this instance
    last_heartbeat: float = 0.0
    name: str = ""  # the Docker names its instance when placed (paper step 3.2)
    # spot-revocation notice: when set, this instance will be terminated
    # at this time (the EC2 two-minute warning).  Workers observe it via
    # WorkerContext.revoked() and drain gracefully before the deadline.
    revoke_at: Optional[float] = None


class SpotMarket:
    """Deterministic spot-market simulation."""

    def __init__(self, fleet_file: FleetFile, clock: Clock):
        self.ff = fleet_file
        self.clock = clock
        self.rng = random.Random(fleet_file.market_seed)
        self.capacity = fleet_file.capacity

    def current_price(self, mt: MachineType) -> float:
        base = mt.on_demand_price * 0.35  # typical spot discount
        if self.ff.price_volatility > 0:
            base *= 1.0 + self.rng.uniform(-1, 1) * self.ff.price_volatility
        return max(base, 0.001)

    def draw_lifetime(self) -> float:
        """Seconds until this instance is preempted (inf if rate==0)."""
        rate = self.ff.preemption_rate_per_hour
        if rate <= 0:
            return float("inf")
        return self.rng.expovariate(rate / 3600.0)


class SpotFleet:
    """A fleet request: maintains ``target_capacity`` instances via the market."""

    def __init__(
        self,
        fleet_file: FleetFile,
        *,
        clock: Optional[Clock] = None,
        app_name: str = "DS",
    ):
        self.clock = clock or WallClock()
        self.ff = fleet_file
        self.app_name = app_name
        self.market = SpotMarket(fleet_file, self.clock)
        self.instances: Dict[str, Instance] = {}
        self.target_capacity = 0
        self.bid: float = 0.0
        self.machine_types: List[MachineType] = []
        self.active = False
        self.replace_on_terminate = True  # disabled by cheapest mode
        self._ids = itertools.count()
        self._preempt_at: Dict[str, float] = {}
        self.request_id: str = ""

    # -- request lifecycle -------------------------------------------------
    def request(self, *, target_capacity: int, bid: float, machine_types: List[str]) -> str:
        self.target_capacity = int(target_capacity)
        self.bid = float(bid)
        self.machine_types = [MACHINE_CATALOGUE[m] for m in machine_types]
        self.active = True
        self.request_id = f"sfr-{self.app_name.lower()}-{next(self._ids):04d}"
        self.tick()
        return self.request_id

    def modify_target(self, target_capacity: int) -> None:
        self.target_capacity = int(target_capacity)

    def cancel(self, *, terminate_instances: bool = True) -> None:
        self.active = False
        self.target_capacity = 0
        if terminate_instances:
            for inst in self.running() + self.pending():
                self._terminate(inst, "fleet-cancelled")

    # -- views ---------------------------------------------------------------
    def running(self) -> List[Instance]:
        return [i for i in self.instances.values() if i.state == InstanceState.RUNNING]

    def pending(self) -> List[Instance]:
        return [i for i in self.instances.values() if i.state == InstanceState.PENDING]

    def alive(self) -> List[Instance]:
        return self.running() + self.pending()

    def fulfilled_capacity(self) -> int:
        return len(self.alive())

    # -- simulation step -------------------------------------------------------
    def tick(self) -> List[Instance]:
        """Advance market state; returns instances terminated this tick."""
        now = self.clock.now()
        terminated: List[Instance] = []

        # 1. preemptions & price-outs
        for inst in list(self.instances.values()):
            if inst.state == InstanceState.TERMINATED:
                continue
            # revocation-notice deadline (chaos-injected or market): the
            # warning window has elapsed, the instance is taken back
            if inst.revoke_at is not None and now >= inst.revoke_at:
                self._terminate(inst, "spot-revocation")
                terminated.append(inst)
                continue
            if self._preempt_at.get(inst.id, float("inf")) <= now:
                self._terminate(inst, "spot-preemption")
                terminated.append(inst)
                continue
            price = self.market.current_price(inst.machine_type)
            if price > self.bid:
                self._terminate(inst, "price-above-bid")
                terminated.append(inst)

        # 2. pending -> running
        for inst in self.pending():
            if now >= inst.ready_time:
                inst.state = InstanceState.RUNNING
                inst.last_heartbeat = now

        # 3. launch up to target (only while the request is active and
        #    replacement allowed — cheapest mode stops back-fill)
        if self.active:
            deficit = self.target_capacity - self.fulfilled_capacity()
            if deficit > 0 and not self.replace_on_terminate and self.fulfilled_capacity() > 0:
                deficit = 0
            for _ in range(max(0, deficit)):
                if len(self.alive()) >= self.market.capacity:
                    break
                mt = self._cheapest_affordable()
                if mt is None:
                    break  # out-bid: capacity stays unfulfilled (paper: "several hours")
                iid = f"i-{self.app_name.lower()}{next(self._ids):06d}"
                inst = Instance(
                    id=iid,
                    machine_type=mt,
                    state=InstanceState.PENDING,
                    launch_time=now,
                    ready_time=now + self.ff.startup_seconds,
                    last_heartbeat=now,
                )
                self.instances[iid] = inst
                life = self.market.draw_lifetime()
                self._preempt_at[iid] = now + life if life != float("inf") else float("inf")

        # 4. excess capacity above target is released (AWS terminates on
        #    downscale with lowest-price strategy)
        excess = self.fulfilled_capacity() - self.target_capacity
        if excess > 0:
            # prefer terminating pending, then idle (no tasks) instances
            victims = sorted(
                self.alive(),
                key=lambda i: (i.state == InstanceState.RUNNING, len(i.tasks)),
            )[:excess]
            for inst in victims:
                self._terminate(inst, "downscale")
                terminated.append(inst)
        return terminated

    def terminate_instance(self, instance_id: str, reason: str = "manual") -> None:
        inst = self.instances.get(instance_id)
        if inst and inst.state != InstanceState.TERMINATED:
            self._terminate(inst, reason)

    # -- internals ----------------------------------------------------------
    def _cheapest_affordable(self) -> Optional[MachineType]:
        affordable = [
            mt for mt in self.machine_types if self.market.current_price(mt) <= self.bid
        ]
        if not affordable:
            return None
        return min(affordable, key=self.market.current_price)

    def _terminate(self, inst: Instance, reason: str) -> None:
        inst.state = InstanceState.TERMINATED
        inst.terminate_time = self.clock.now()
        inst.terminate_reason = reason
        inst.tasks.clear()
