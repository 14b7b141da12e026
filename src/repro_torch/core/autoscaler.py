"""Autoscaler — sizes the serving fleet to its load, without flapping.

The port's own copy of the reference package's ``core/autoscaler.py`` (the
port imports nothing of the reference), behaviour unchanged.

The paper sizes the fleet once (``CLUSTER_MACHINES``) and leaves it; the
monitor only ever scales *down* (idle alarms, cheapest mode, teardown).
This control loop closes the other half: the monitor ticks it once per
poll, it reads demand from two deterministic signals, and it drives
``SpotFleet.modify_target`` + ``ECSCluster.update_desired_count``.

Signals
-------
- **queue depth**: serve leases report their shared request queue's
  ``visible + in_flight`` in heartbeat progress payloads (collected on
  the runtime's :class:`ProgressBoard`).  Every lease reports the *same*
  queue, so the policy takes the max over fresh reports — summing would
  multiply demand by the worker count.  With no fresh report (fleet
  still starting), the *job* queue's counts are the fallback.
- **SLO** (``autoscale=slo``): leases also report p99 TTFT (engine
  ticks) from their scheduler timing window; when the worst fresh p99
  exceeds ``autoscale_target_p99_ttft`` the fleet scales up regardless
  of queue depth.

**Role-split fleets**: when fresh reports carry ``role`` tags of
``prefill``/``decode`` (a disaggregated fleet), the policy sizes the
two pools independently — prefill off its request-queue backlog,
decode off the decode-queue backlog, active-slot pressure and (under
``slo``) decode-side p99 TTFT — and sums them into the single fleet
target.  Without role tags the legacy single-pool policy runs
unchanged.

Anti-flap machinery, all explicit knobs on :class:`~.config.DSConfig`:
hysteresis (inside the band ``(target/2, target]`` the fleet holds
rather than shrinking), separate scale-up / scale-down cooldowns (a
scale-down additionally waits out the *up* cooldown, so a spike
followed by quiet does not thrash), and a per-decision step bound
(``autoscale_max_step``).  Targets always clamp to
``[min_workers, max_workers]``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .clock import Clock
from .cluster import ECSCluster
from .config import DSConfig
from .fleet import SpotFleet
from .logs import LogGroup
from .queue import DurableQueue


class ProgressBoard:
    """Latest heartbeat progress payload per worker, with timestamps.

    Written from worker heartbeat paths (possibly many threads), read by
    the autoscaler on the monitor thread — hence the lock.  Stale
    entries (dead workers) age out via the ``fresh()`` window instead of
    requiring explicit deregistration.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._latest: Dict[str, Tuple[float, dict]] = {}

    def put(self, worker_id: str, payload: dict, now: float) -> None:
        with self._lock:
            self._latest[worker_id] = (now, dict(payload))

    def fresh(self, now: float, max_age: float) -> List[dict]:
        with self._lock:
            return [
                payload
                for t, payload in self._latest.values()
                if now - t <= max_age
            ]


@dataclass
class ScaleDecision:
    time: float
    current: int
    desired: int
    applied: bool
    reason: str


class Autoscaler:
    def __init__(
        self,
        cfg: DSConfig,
        queue: DurableQueue,
        fleet: SpotFleet,
        cluster: ECSCluster,
        *,
        clock: Clock,
        logs: Optional[LogGroup] = None,
        board: Optional[ProgressBoard] = None,
    ):
        self.cfg = cfg
        self.queue = queue
        self.fleet = fleet
        self.cluster = cluster
        self.clock = clock
        self.logs = logs
        self.board = board
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        self.decisions: List[ScaleDecision] = []

    # ------------------------------------------------------------------ tick
    def tick(self) -> Optional[ScaleDecision]:
        cfg = self.cfg
        if cfg.autoscale == "off":
            return None
        now = self.clock.now()
        current = self.fleet.target_capacity
        max_age = max(2 * cfg.monitor_poll_seconds, 120.0)
        reports = [
            p
            for p in (self.board.fresh(now, max_age) if self.board else [])
            if p.get("kind") == "serve"
        ]
        if any(p.get("role") in ("prefill", "decode") for p in reports):
            # disaggregated fleet: per-role pools, summed into the one
            # fleet target (see _split_desired)
            desired, reason = self._split_desired(reports, current)
        else:
            if reports:
                backlog = max(int(p.get("backlog", 0)) for p in reports)
                signal = "reported"
            else:
                c = self.queue.counts()
                backlog = c["visible"] + c["in_flight"]
                signal = "job-queue"
            desired = math.ceil(backlog / max(1, cfg.autoscale_queue_per_worker))
            reason = f"{signal} backlog={backlog}"

            if cfg.autoscale == "slo" and reports:
                p99 = max(float(p.get("p99_ttft", 0.0)) for p in reports)
                target = cfg.autoscale_target_p99_ttft
                if p99 > target:
                    # SLO breach: step up as fast as the bound allows, even
                    # if the queue-depth policy thinks capacity suffices
                    desired = max(desired, current + cfg.autoscale_max_step)
                    reason = f"slo breach p99_ttft={p99:.1f}>{target:.1f}"
                elif p99 > target / 2 and desired < current:
                    # hysteresis band: latency is within SLO but not by a
                    # 2x margin — hold rather than shrink into a breach
                    desired = current
                    reason = f"slo hold p99_ttft={p99:.1f} in ({target/2:.1f},{target:.1f}]"

        desired = max(cfg.min_workers, min(cfg.max_workers, desired))
        # per-decision step bound
        desired = max(current - cfg.autoscale_max_step,
                      min(current + cfg.autoscale_max_step, desired))

        applied = False
        if desired > current:
            if now - self._last_up >= cfg.autoscale_up_cooldown_seconds:
                self._apply(desired)
                self._last_up = now
                applied = True
            else:
                reason += " (up-cooldown)"
        elif desired < current:
            # a scale-down also waits out the up-cooldown so a spike
            # followed by one quiet poll cannot flap the fleet
            if now - max(self._last_up, self._last_down) >= (
                cfg.autoscale_down_cooldown_seconds
            ):
                self._apply(desired)
                self._last_down = now
                applied = True
            else:
                reason += " (down-cooldown)"
        decision = ScaleDecision(
            time=now, current=current, desired=desired,
            applied=applied, reason=reason,
        )
        self.decisions.append(decision)
        if applied and self.logs is not None:
            self.logs.put(
                "autoscaler",
                f"scale {current} -> {desired} ({reason})",
            )
        return decision

    # ------------------------------------- disaggregated per-role pools
    def _split_desired(self, reports: List[dict],
                       current: int) -> Tuple[int, str]:
        """Size a role-split fleet: two pools, one fleet target.

        The prefill pool is demand-driven off the *request-queue* backlog
        (prefill leases report it): prompts waiting to be prefilled are
        the only signal that pool can act on.  The decode pool is sized
        off the *decode-queue* backlog (decode leases report THEIR
        queue) and active-slot pressure, and under ``autoscale=slo``
        additionally steps up past any queue-depth answer when the worst
        fresh decode p99 TTFT breaches the target — TTFT on a split
        fleet is dominated by the decode side's admission latency.  Each
        pool with live leases keeps a floor of one worker (a pipeline
        with either stage empty serves nothing).  The sum feeds the
        caller's shared clamp/step/cooldown machinery; reasons carry the
        per-role breakdown so scale decisions stay auditable."""
        cfg = self.cfg
        qpw = max(1, cfg.autoscale_queue_per_worker)
        pre = [p for p in reports if p.get("role") == "prefill"]
        dec = [p for p in reports if p.get("role") == "decode"]
        uni = [p for p in reports if p.get("role", "unified") == "unified"]

        pre_backlog = max((int(p.get("backlog", 0)) for p in pre), default=0)
        want_pre = math.ceil(pre_backlog / qpw)
        if pre:
            want_pre = max(1, want_pre)

        dec_backlog = max((int(p.get("backlog", 0)) for p in dec), default=0)
        dec_active = sum(int(p.get("active", 0)) for p in dec)
        want_dec = max(
            math.ceil(dec_backlog / qpw), math.ceil(dec_active / qpw)
        )
        if dec:
            want_dec = max(1, want_dec)

        # a mixed fleet (unified leases riding along) sizes its legacy
        # share exactly as the non-split policy would
        uni_backlog = max((int(p.get("backlog", 0)) for p in uni), default=0)
        want_uni = math.ceil(uni_backlog / qpw)

        desired = want_pre + want_dec + want_uni
        reason = f"role-split prefill={want_pre} decode={want_dec}"
        if uni:
            reason += f" unified={want_uni}"

        if cfg.autoscale == "slo" and dec:
            p99 = max(float(p.get("p99_ttft", 0.0)) for p in dec)
            target = cfg.autoscale_target_p99_ttft
            if p99 > target:
                # step the DECODE pool up by the bound from its live
                # size; the prefill share is preserved on top
                desired = max(
                    desired, want_pre + len(dec) + cfg.autoscale_max_step
                )
                reason = (
                    f"decode slo breach p99_ttft={p99:.1f}>{target:.1f} "
                    f"(prefill={want_pre})"
                )
            elif p99 > target / 2 and desired < current:
                desired = current
                reason = (
                    f"decode slo hold p99_ttft={p99:.1f} "
                    f"in ({target/2:.1f},{target:.1f}]"
                )
        return desired, reason

    def _apply(self, desired: int) -> None:
        self.fleet.modify_target(desired)
        svc = f"{self.cfg.app_name}Service"
        if svc in self.cluster.services:
            self.cluster.update_desired_count(
                svc, desired * self.cfg.tasks_per_machine
            )
