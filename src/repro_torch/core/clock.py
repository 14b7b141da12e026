"""Clock abstraction so the DS control plane is deterministically testable.

The port's own copy of the reference package's ``core/clock.py`` (the
port imports nothing of the reference), behaviour unchanged.

The paper's control plane is driven by wall-clock behaviours (SQS message
visibility timeouts, CloudWatch "CPU < 1% for 15 minutes" alarms, the
monitor's once-per-minute poll).  We route every time read/sleep through a
``Clock`` so tests and the simulation runner can use a ``VirtualClock``
and advance time explicitly, while real local runs use ``WallClock``.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Interface: ``now()`` returns seconds, ``sleep(dt)`` advances/blocks."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class VirtualClock(Clock):
    """Deterministic clock; ``sleep`` advances time instead of blocking.

    Thread-safe so the thread runner can also use it in stress tests.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError("cannot advance clock backwards")
        with self._lock:
            self._t += float(seconds)
            return self._t
