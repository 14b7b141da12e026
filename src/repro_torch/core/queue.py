"""Durable work queue — the framework's SQS analogue.

The port's own copy of the reference package's ``core/queue.py`` (the
port imports nothing of the reference), behaviour unchanged.

This is the heart of the paper's fault-tolerance story and is reproduced
with full SQS semantics:

- **at-least-once delivery**: a received message is *hidden*, not removed;
  if the worker never calls :meth:`delete` (crash, preemption, stall) the
  message becomes visible again after its *visibility timeout* and another
  worker picks it up (paper: ``SQS_MESSAGE_VISIBILITY``);
- **visibility extension**: long-running jobs keep extending their lease
  (``change_visibility``), the DS worker loop does this from a heartbeat;
- **dead-letter queue**: after ``max_receive_count`` receives a message is
  moved to the DLQ instead of being retried forever, so one poison job
  "(such as one where a single file has been corrupted)" cannot keep the
  cluster alive indefinitely (paper: ``SQS_DEAD_LETTER_QUEUE``);
- **approximate counts**: visible vs in-flight, which the monitor polls
  once per "minute" to drive autoscaling and teardown.

Durability is SQLite (WAL journal): the queue file survives process
crashes, and all state transitions are single transactions.  A
``VirtualClock`` can be injected so tests control time.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .clock import Clock, WallClock

# Fault-injection seam for chaos drills.  Hooks are registered per queue
# *path*, not per instance: every lease opens its own handle on the same
# sqlite file, so an instance-level wrapper would miss the consumers that
# matter.  A registered hook is called as ``hook(op, path)`` before the
# consumer-side operations ("receive" / "delete"); raising from the hook
# makes the call fail exactly as a transient network fault would, without
# touching queue state.  Producer-side sends are never faulted — the
# drills target the worker's retry discipline, not test setup.
_FAULT_HOOKS: Dict[str, Callable[[str, str], None]] = {}


def install_fault_hook(path: str, hook: Callable[[str, str], None]) -> None:
    """Register (or replace) the fault hook for a queue path."""
    _FAULT_HOOKS[os.path.abspath(path)] = hook


def remove_fault_hook(path: str) -> None:
    _FAULT_HOOKS.pop(os.path.abspath(path), None)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS messages (
    id            TEXT PRIMARY KEY,
    body          TEXT NOT NULL,
    enqueued_at   REAL NOT NULL,
    visible_at    REAL NOT NULL,
    receive_count INTEGER NOT NULL DEFAULT 0,
    receipt       TEXT
);
-- composite index: the claim query filters on visible_at and orders by
-- enqueued_at — one index serves both, so batch claims stay a single
-- range scan instead of a scan + sort.  It prefix-subsumes the old
-- single-column idx_visible, which is dropped to keep writes single-index.
DROP INDEX IF EXISTS idx_visible;
CREATE INDEX IF NOT EXISTS idx_ready ON messages (visible_at, enqueued_at);
CREATE TABLE IF NOT EXISTS dead_letters (
    id            TEXT PRIMARY KEY,
    body          TEXT NOT NULL,
    enqueued_at   REAL NOT NULL,
    died_at       REAL NOT NULL,
    receive_count INTEGER NOT NULL
);
"""


@dataclass
class Message:
    id: str
    body: Any
    receipt: str
    receive_count: int


class DurableQueue:
    """SQLite-backed queue with SQS visibility-timeout semantics."""

    def __init__(
        self,
        path: str,
        *,
        default_visibility: float = 60.0,
        max_receive_count: int = 3,
        clock: Optional[Clock] = None,
    ):
        self.path = path
        self._fault_key = os.path.abspath(path)
        self.default_visibility = float(default_visibility)
        self.max_receive_count = int(max_receive_count)
        self.clock = clock or WallClock()
        self._lock = threading.Lock()
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def _maybe_fault(self, op: str) -> None:
        hook = _FAULT_HOOKS.get(self._fault_key)
        if hook is not None:
            hook(op, self.path)

    # -- producer ----------------------------------------------------------
    def send(self, body: Any) -> str:
        return self.send_batch([body])[0]

    def send_batch(self, bodies: List[Any]) -> List[str]:
        now = self.clock.now()
        rows = [(uuid.uuid4().hex, json.dumps(body), now, now) for body in bodies]
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT INTO messages (id, body, enqueued_at, visible_at) VALUES (?,?,?,?)",
                rows,
            )
        return [r[0] for r in rows]

    # -- consumer ----------------------------------------------------------
    def receive(self, visibility_timeout: Optional[float] = None) -> Optional[Message]:
        """Atomically claim the oldest visible message, or ``None``.

        Messages that have exceeded ``max_receive_count`` are moved to the
        dead-letter table at claim time (SQS redrive policy).
        """
        msgs = self.receive_batch(1, visibility_timeout)
        return msgs[0] if msgs else None

    def receive_batch(
        self, max_messages: int = 10, visibility_timeout: Optional[float] = None
    ) -> List[Message]:
        """Atomically claim up to ``max_messages`` oldest visible messages
        in ONE transaction (SQS ``ReceiveMessage`` with ``MaxNumber...``).

        High-fanout consumers previously paid one lock acquisition + SQL
        round-trip per job; this claims a whole batch under a single lock
        with a single indexed range scan, DLQ-ing poison messages as they
        are encountered.  Returns fewer than ``max_messages`` (possibly
        none) if the queue runs dry.
        """
        self._maybe_fault("receive")
        vt = self.default_visibility if visibility_timeout is None else float(visibility_timeout)
        now = self.clock.now()
        claimed: List[Message] = []
        seen: set = set()  # ids handled this call: with vt <= 0 a claimed
        #                    message stays visible and would be re-selected
        #                    forever (duplicate delivery + spurious DLQ)
        with self._lock, self._conn:
            while len(claimed) < max_messages:
                # over-fetch by len(seen): still-visible already-claimed rows
                # (vt <= 0) sit at the front of the ordering and must not
                # mask unseen candidates behind the LIMIT
                want = max_messages - len(claimed) + len(seen)
                # tie-break equal enqueued_at by rowid (insertion order),
                # not id: ids are uuid4, so an id tie-break shuffles the
                # claim order of same-instant messages from run to run —
                # rowid keeps claim order FIFO and replay-deterministic
                # (release() is an UPDATE, so a message keeps its rowid)
                rows = self._conn.execute(
                    "SELECT id, body, enqueued_at, receive_count FROM messages "
                    "WHERE visible_at <= ? ORDER BY enqueued_at, rowid LIMIT ?",
                    (now, want),
                ).fetchall()
                rows = [r for r in rows if r[0] not in seen][: max_messages - len(claimed)]
                if not rows:
                    break
                for mid, body, enq, rc in rows:
                    seen.add(mid)
                    if rc >= self.max_receive_count:
                        # poison message -> DLQ
                        self._conn.execute("DELETE FROM messages WHERE id = ?", (mid,))
                        self._conn.execute(
                            "INSERT OR REPLACE INTO dead_letters VALUES (?,?,?,?,?)",
                            (mid, body, enq, now, rc),
                        )
                        continue
                    receipt = uuid.uuid4().hex
                    self._conn.execute(
                        "UPDATE messages SET visible_at = ?, receive_count = ?, receipt = ? "
                        "WHERE id = ?",
                        (now + vt, rc + 1, receipt, mid),
                    )
                    claimed.append(
                        Message(
                            id=mid,
                            body=json.loads(body),
                            receipt=receipt,
                            receive_count=rc + 1,
                        )
                    )
        return claimed

    def delete(self, message: Message) -> bool:
        """Acknowledge successful processing.  Receipt-checked like SQS —
        a stale receipt (message already re-delivered elsewhere) is a no-op."""
        return self.delete_batch([message]) == 1

    def delete_batch(self, messages: List[Message]) -> int:
        """Acknowledge a batch in one transaction (SQS ``DeleteMessageBatch``).

        Returns the number actually deleted; stale receipts are no-ops,
        mirroring :meth:`delete`."""
        self._maybe_fault("delete")
        with self._lock, self._conn:
            deleted = 0
            for m in messages:
                cur = self._conn.execute(
                    "DELETE FROM messages WHERE id = ? AND receipt = ?",
                    (m.id, m.receipt),
                )
                deleted += cur.rowcount
            return deleted

    def change_visibility(self, message: Message, visibility_timeout: float) -> bool:
        """Extend (or shrink) the lease on an in-flight message."""
        now = self.clock.now()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE messages SET visible_at = ? WHERE id = ? AND receipt = ?",
                (now + float(visibility_timeout), message.id, message.receipt),
            )
            return cur.rowcount > 0

    def release(self, message: Message, delay: float = 0.0) -> bool:
        """Return a message to the queue WITHOUT consuming retry budget.

        Used for not-ready-yet jobs (e.g. a training span whose
        prerequisite checkpoint has not landed): the receive is undone
        (receive_count decremented) and the message reappears after
        ``delay`` — waiting on a dependency must not march a job toward
        the dead-letter queue."""
        now = self.clock.now()
        with self._lock, self._conn:
            # re-enqueue at the BACK (enqueued_at = now): a waiting job must
            # not starve runnable jobs behind it in FIFO order
            cur = self._conn.execute(
                "UPDATE messages SET visible_at = ?, enqueued_at = ?, "
                "receive_count = receive_count - 1, receipt = NULL "
                "WHERE id = ? AND receipt = ?",
                (now + float(delay), now, message.id, message.receipt),
            )
            return cur.rowcount > 0

    # -- introspection -------------------------------------------------------
    def counts(self) -> dict:
        """Approximate numbers the monitor polls: visible / in-flight / dead."""
        now = self.clock.now()
        with self._lock:
            visible = self._conn.execute(
                "SELECT COUNT(*) FROM messages WHERE visible_at <= ?", (now,)
            ).fetchone()[0]
            inflight = self._conn.execute(
                "SELECT COUNT(*) FROM messages WHERE visible_at > ?", (now,)
            ).fetchone()[0]
            dead = self._conn.execute("SELECT COUNT(*) FROM dead_letters").fetchone()[0]
        return {"visible": visible, "in_flight": inflight, "dead": dead}

    def dead_letters(self) -> List[Message]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, body, receive_count FROM dead_letters ORDER BY died_at"
            ).fetchall()
        return [Message(id=r[0], body=json.loads(r[1]), receipt="", receive_count=r[2]) for r in rows]

    def redrive_dead_letters(self) -> int:
        """Move DLQ messages back to the main queue (operator action)."""
        now = self.clock.now()
        with self._lock, self._conn:
            rows = self._conn.execute("SELECT id, body FROM dead_letters").fetchall()
            for mid, body in rows:
                self._conn.execute(
                    "INSERT OR REPLACE INTO messages (id, body, enqueued_at, visible_at, receive_count)"
                    " VALUES (?,?,?,?,0)",
                    (mid, body, now, now),
                )
            self._conn.execute("DELETE FROM dead_letters")
        return len(rows)

    def purge(self) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM messages")
            self._conn.execute("DELETE FROM dead_letters")

    def close(self) -> None:
        with self._lock:
            self._conn.close()
