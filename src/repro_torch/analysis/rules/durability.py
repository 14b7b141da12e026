"""R2 — durable-before-ack ordering.

Motivating bug class: a request message deleted *before* its
completion record / checkpoint / handoff marker is durable in the
object store cannot be resurfaced by the visibility timeout — a worker
crash in the gap silently loses the request. The serving lease's
contract is therefore put-THEN-delete, everywhere.

The rule does per-function call-order analysis in lease/handler
modules: within one ordering region (a function body, or each loop
body — different loops process different message populations, so
cross-loop order is meaningless), a queue ack (``delete`` /
``delete_batch``) must not precede a durable store put (``put_json`` /
``put_bytes``) that appears later in the same region.  An ack with no
later put in its region guards nothing and is fine (e.g. acking a
redelivered, already-recorded request).
"""

from __future__ import annotations

import ast
from typing import List, Tuple

from repro_torch.analysis.rules.common import (
    ACK_OPS,
    DURABLE_PUT_OPS,
    Rule,
    ancestors,
    is_queue_receiver,
    is_store_receiver,
    receiver_terminal,
)


def _region_of(node: ast.AST, func: ast.AST) -> ast.AST:
    """Innermost loop enclosing ``node`` within ``func`` (or ``func``)."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.For, ast.While)):
            return anc
        if anc is func:
            break
    return func


class DurableBeforeAckRule(Rule):
    rule_id = "R2"
    title = ("a queue ack must not precede the durable store write it "
             "guards (put-then-delete)")

    def check_module(self, module, project):
        if not ({"lease", "handler"} & module.roles):
            return
        for func in ast.walk(module.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # events: (region id, lineno, kind, label), in source order
            events: List[Tuple[int, int, str, str]] = []
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                # skip calls belonging to a nested def (it has its own pass)
                owner = next(
                    (a for a in ancestors(node)
                     if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))),
                    None,
                )
                if owner is not func:
                    continue
                recv, op = receiver_terminal(node)
                if is_queue_receiver(recv) and op in ACK_OPS:
                    kind = "ack"
                elif is_store_receiver(recv) and op in DURABLE_PUT_OPS:
                    kind = "put"
                else:
                    continue
                region = _region_of(node, func)
                events.append((id(region), node.lineno, kind, f"{recv}.{op}"))
            by_region = {}
            for rid, line, kind, label in sorted(events, key=lambda e: e[1]):
                by_region.setdefault(rid, []).append((line, kind, label))
            for seq in by_region.values():
                for i, (line, kind, label) in enumerate(seq):
                    if kind != "ack":
                        continue
                    later_put = next(
                        (lbl for _ln, k, lbl in seq[i + 1:] if k == "put"),
                        None,
                    )
                    if later_put is not None:
                        yield module.finding(
                            "R2", line,
                            f"queue ack {label}() precedes the durable "
                            f"{later_put}() below it — a crash in the gap "
                            "loses the request (the visibility timeout "
                            "cannot resurface a deleted message); write "
                            "durable state first, then ack",
                        )
