"""R1 — retry-discipline on the lease path.

Motivating bug: chaos ``flaky_storage``/``flaky_queue`` windows
crashed serving leases because store/queue operations were called bare
— a single transient ``ConnectionError`` killed the worker, losing the
in-memory segment.  The fix wrapped every lease-path operation in
``_with_retries`` (capped content-keyed backoff); this rule keeps it
that way: in lease-role modules (``launch/serve.py``,
``serving/prefix_store.py``) every ``ObjectStore``/``DurableQueue``
method call must run under a retry wrapper (``_with_retries``,
``_retry_transient``) or inside ``AsyncPublisher`` (whose worker
retries every put).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules.common import (
    QUEUE_OPS,
    STORE_OPS,
    Rule,
    in_retry_context,
    is_queue_receiver,
    is_store_receiver,
    receiver_terminal,
)


class RetryDisciplineRule(Rule):
    rule_id = "R1"
    title = ("lease-path store/queue ops must flow through _with_retries/"
             "AsyncPublisher, never bare")

    def check_module(self, module, project):
        if "lease" not in module.roles:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            recv, op = receiver_terminal(node)
            if not recv:
                continue
            kind = None
            if is_store_receiver(recv) and op in STORE_OPS:
                kind = "store"
            elif is_queue_receiver(recv) and op in QUEUE_OPS:
                kind = "queue"
            if kind is None:
                continue
            if in_retry_context(node):
                continue
            yield module.finding(
                "R1", node,
                f"bare {kind} op {recv}.{op}() on the lease path — a "
                "transient ConnectionError here kills the lease; wrap it "
                "in _with_retries(...) (or route puts through "
                "AsyncPublisher)",
            )
