"""Log groups/streams — the CloudWatch analogue.

The port's own copy of the reference package's ``core/logs.py`` (the
port imports nothing of the reference), behaviour unchanged.

Per the paper: each job writes a log of tool output; each container
writes a per-instance log of CPU/memory/disk usage; at teardown the
monitor exports all logs to the object store (S3 export task).
"""

from __future__ import annotations

import json
import threading
from collections import defaultdict
from typing import Dict, List, Optional

from .clock import Clock, WallClock
from .storage import ObjectStore


class LogGroup:
    def __init__(self, name: str, clock: Optional[Clock] = None):
        self.name = name
        self.clock = clock or WallClock()
        self._streams: Dict[str, List[dict]] = defaultdict(list)
        self._lock = threading.Lock()

    def put(self, stream: str, message: str, **fields) -> None:
        event = {"ts": self.clock.now(), "message": message}
        if fields:
            event.update(fields)
        with self._lock:
            self._streams[stream].append(event)

    def streams(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def events(self, stream: str) -> List[dict]:
        with self._lock:
            return list(self._streams.get(stream, []))

    def export(self, store: ObjectStore, prefix: str) -> int:
        """Export all streams as JSONL objects (the S3 export task)."""
        n = 0
        with self._lock:
            items = {s: list(evs) for s, evs in self._streams.items()}
        for stream, events in items.items():
            body = "\n".join(json.dumps(e, sort_keys=True) for e in events)
            store.put_text(f"{prefix}/{self.name}/{stream}.jsonl", body)
            n += 1
        return n


class MetricRegistry:
    """Minimal CloudWatch-metrics analogue: last-value gauges + counters,
    queried by the monitor for alarm evaluation."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or WallClock()
        self._gauges: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = (self.clock.now(), float(value))

    def read(self, name: str) -> Optional[tuple]:
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self) -> Dict[str, tuple]:
        with self._lock:
            return dict(self._gauges)
