"""Shared AST helpers for the dslint rules."""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Tuple, Type


class Rule:
    """Base class: rules override one or both hooks."""

    rule_id: str = "R?"
    title: str = ""

    def check_module(self, module, project):  # noqa: ARG002 - interface
        return ()

    def check_project(self, project):  # noqa: ARG002 - interface
        return ()


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    """Walk parent links attached by the engine (innermost first)."""
    cur = getattr(node, "_dslint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_dslint_parent", None)


def enclosing(node: ast.AST, *types: Type[ast.AST]) -> Optional[ast.AST]:
    for anc in ancestors(node):
        if isinstance(anc, types):
            return anc
    return None


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, "" for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def receiver_terminal(call: ast.Call) -> Tuple[str, str]:
    """For a method call ``recv.op(...)``: (terminal receiver name, op).

    The terminal name is the last attribute/name of the receiver chain
    (``ctx.store.put_json`` -> ("store", "put_json"); ``rq.delete`` ->
    ("rq", "delete")).  Non-method calls return ("", "")."""
    if not isinstance(call.func, ast.Attribute):
        return "", ""
    recv = call.func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr, call.func.attr
    if isinstance(recv, ast.Name):
        return recv.id, call.func.attr
    return "", ""


def is_store_receiver(name: str) -> bool:
    return name == "store" or name.endswith("store")


def is_queue_receiver(name: str) -> bool:
    return name in ("rq", "dq", "queue") or name.endswith("queue")


STORE_OPS = frozenset({
    "put_bytes", "get_bytes", "put_json", "get_json",
    "list", "exists", "delete", "delete_prefix",
})
QUEUE_OPS = frozenset({
    "send", "send_batch", "receive", "receive_batch",
    "delete", "delete_batch", "release", "change_visibility",
    "redrive_dead_letters",
})
# acks make a message unrecoverable; durable puts are what must precede
ACK_OPS = frozenset({"delete", "delete_batch"})
DURABLE_PUT_OPS = frozenset({"put_json", "put_bytes"})

# wrappers that give a call transient-fault retry (the lease-path retry discipline)
RETRY_WRAPPERS = frozenset({"_with_retries", "_retry_transient"})


def in_retry_context(call: ast.Call) -> bool:
    """True if ``call`` runs under a retry wrapper: lexically inside a
    ``_with_retries(...)`` / ``_retry_transient(...)`` argument, inside
    the wrapper's own definition, or inside ``AsyncPublisher`` (whose
    worker retries every put with capped content-keyed backoff)."""
    for anc in ancestors(call):
        if isinstance(anc, ast.Call):
            name = call_name(anc).rsplit(".", 1)[-1]
            if name in RETRY_WRAPPERS:
                return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if anc.name in RETRY_WRAPPERS:
                return True
        if isinstance(anc, ast.ClassDef) and anc.name == "AsyncPublisher":
            return True
    return False


def self_attr_target(node: ast.AST) -> Optional[str]:
    """``self.x`` in a store context -> "x"."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def is_lock_guarded(node: ast.AST) -> bool:
    """True when an ancestor ``with`` acquires something lock-like
    (``with self._lock:``, ``with lock:``, ``with self.mutex:``)."""
    for anc in ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                name = dotted_name(item.context_expr).lower()
                if "lock" in name or "mutex" in name:
                    return True
    return False
