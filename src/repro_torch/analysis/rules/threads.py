"""R5 — thread-shared state must be lock-guarded or ownership-declared.

Motivating bug: ``AsyncPublisher`` originally mutated its
``_pending`` dedup map from both the caller thread (``publish``) and the
background worker thread without a lock; under load the map lost
entries and the publisher re-uploaded segments it had already shipped.
The fix guards every ``_pending`` touch with ``self._lock``.

The rule works per class: if a class starts a thread whose target is
one of its *own* methods (``threading.Thread(target=self._run, ...)``)
the attributes that method (transitively, via same-class method calls)
writes form the *worker-side* set; attributes written by the remaining
methods form the *caller-side* set.  Any attribute **written on both
sides** where at least one write is not under a ``with ...lock:`` block
is a finding.  Single-writer attributes (written by one side, read by
the other) pass: CPython attribute stores are atomic, and the repo's
convention is single-writer ownership with the owner declared in the
class docstring.

Suppress with ``# dslint: disable=R5(reason)`` on the offending write
(or the method header) when ownership is established another way —
e.g. a handoff happens-before relationship via ``queue.Queue`` or
``Thread.join``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.rules.common import (
    Rule,
    ancestors,
    dotted_name,
    is_lock_guarded,
    self_attr_target,
)


def _thread_targets(cls: ast.ClassDef) -> Set[str]:
    """Method names of ``cls`` used as ``Thread(target=self.<m>)``."""
    targets: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        fn = dotted_name(node.func)
        if not fn.endswith("Thread"):
            continue
        for kw in node.keywords:
            if kw.arg == "target":
                name = dotted_name(kw.value)
                if name.startswith("self."):
                    targets.add(name.split(".", 1)[1])
    return targets


def _methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {
        stmt.name: stmt
        for stmt in cls.body
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _owned_by(node: ast.AST, methods: Dict[str, ast.FunctionDef]) -> Optional[str]:
    """Name of the class method whose body contains ``node``."""
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for name, m in methods.items():
                if m is anc:
                    return name
            return None
    return None


def _self_writes(func: ast.AST) -> List[ast.Attribute]:
    """``self.x`` attribute nodes that are write targets in ``func`` —
    assignment, augmented assignment, and in-place mutation through a
    method call (``self.x.append/pop/add/...``) or subscript store."""
    mutators = {
        "append", "extend", "add", "discard", "remove", "pop", "popleft",
        "appendleft", "clear", "update", "setdefault", "insert",
    }
    out: List[ast.Attribute] = []
    for node in ast.walk(func):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                # plain `self.x = ...` and `self.x[k] = ...`
                base = t.value if isinstance(t, ast.Subscript) else t
                if self_attr_target(base):
                    out.append(base)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in mutators and self_attr_target(node.func.value):
                out.append(node.func.value)
        elif isinstance(node, (ast.Delete,)):
            for t in node.targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if isinstance(base, ast.Attribute) and self_attr_target(base):
                    out.append(base)
    return out


def _reachable(start: Set[str], methods: Dict[str, ast.FunctionDef]) -> Set[str]:
    """Methods transitively called from ``start`` via ``self.<m>()``."""
    seen = set(start)
    frontier = list(start)
    while frontier:
        name = frontier.pop()
        func = methods.get(name)
        if func is None:
            continue
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                if callee.startswith("self."):
                    m = callee.split(".", 1)[1]
                    if m in methods and m not in seen:
                        seen.add(m)
                        frontier.append(m)
    return seen


class ThreadSharedStateRule(Rule):
    rule_id = "R5"
    title = ("attributes written from both a Thread target and the caller "
             "side must be lock-guarded (or ownership-declared via pragma)")

    def check_module(self, module, project):
        # lease modules run under ThreadRunner workers: a module-level
        # mutable container is reachable from every worker thread in the
        # process, so it must declare its ownership story (per-worker
        # keying, GIL-atomic single op, ...) via pragma or grow a lock
        if "lease" in module.roles:
            for stmt in module.tree.body:
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    continue
                value = stmt.value
                if value is None or not isinstance(
                    value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                            ast.ListComp, ast.SetComp)
                ):
                    continue
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    if isinstance(t, ast.Name) and "lock" not in t.id.lower():
                        yield module.finding(
                            "R5", stmt,
                            f"module-level mutable container {t.id} in a "
                            "lease module is shared across worker threads "
                            "— declare its ownership/atomicity story with "
                            "# dslint: disable=R5(reason) or guard it with "
                            "a lock",
                        )
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            starts = _thread_targets(cls)
            if not starts:
                continue
            methods = _methods(cls)
            worker_methods = _reachable(starts, methods)
            # __init__ runs before the thread starts: its writes are
            # publication, not contention
            caller_methods = {
                n for n in methods
                if n not in worker_methods and n != "__init__"
            }

            def side_writes(names: Set[str]) -> Dict[str, List[ast.Attribute]]:
                writes: Dict[str, List[ast.Attribute]] = {}
                for n in names:
                    for attr_node in _self_writes(methods[n]):
                        writes.setdefault(attr_node.attr, []).append(attr_node)
                return writes

            worker_writes = side_writes(worker_methods)
            caller_writes = side_writes(caller_methods)
            shared = set(worker_writes) & set(caller_writes)
            for attr in sorted(shared):
                if "lock" in attr or "mutex" in attr:
                    continue  # the lock object itself
                unguarded = [
                    n for n in worker_writes[attr] + caller_writes[attr]
                    if not is_lock_guarded(n)
                ]
                for node in unguarded:
                    owner = _owned_by(node, methods)
                    yield module.finding(
                        "R5", node,
                        f"attribute self.{attr} is written from both the "
                        f"{cls.name} thread target and the caller side, but "
                        f"this write (in {owner or '?'}) is not under a "
                        "lock — guard it with `with self._lock:` or declare "
                        "single-writer ownership with a pragma",
                    )
