"""R4 — counter-registry drift.

Motivating bugs: three times a new ``EngineStats`` counter was plumbed
into some-but-not-all of its consumers — present in ``snapshot()`` but
missing from the ``docs/serving.md`` counter tables, or named in the
bench schema checker under a stale name after a rename — and the drift
was only caught by a reviewer reading diffs side by side. The three
registries can never silently diverge again:

1. every public ``EngineStats`` field must be covered by
   ``snapshot()`` (the dynamic ``fields(self)`` comprehension covers
   all of them; an explicit-dict rewrite must name each one);
2. every public field must appear (backticked) in ``docs/serving.md``;
3. every key ``check_bench.py`` requires of a report must be a real
   ``EngineStats`` field, a ``snapshot()``-derived key, or declared in
   ``check_bench.DERIVED_KEYS`` (bench-level derived metrics) — a
   renamed counter fails here instead of silently passing a schema
   that no report can satisfy;
4. (absorbed from the standalone ``check_bench`` CLI) every scenario
   block in the bench schema must be referenced by a tier-1 smoke
   assertion in the bench's smoke test, and a committed report must
   satisfy the schema.

The port's anchors for parts 3-4 are its own benchmark's files:
``benchmarks_torch/check_bench.py`` (the schema checker, loaded by
path), ``tests/test_torch_bench_serving.py`` (its smoke test) and
``BENCH_serving_torch.json`` (its committed report).  The reference's
``benchmarks/`` is never read.  Until those files exist parts 3-4 skip
quietly, as every rule does for an absent anchor.
"""

from __future__ import annotations

import ast
import importlib.util
import os
from typing import List, Optional, Set

from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules.common import Rule

TYPES_PATH = "src/repro_torch/serving/types.py"
DOCS_PATH = "docs/serving.md"
CHECK_BENCH_PATH = os.path.join("benchmarks_torch", "check_bench.py")
BENCH_TEST_PATH = os.path.join("tests", "test_torch_bench_serving.py")
BENCH_REPORT_PATH = "BENCH_serving_torch.json"


def _engine_stats_fields(module) -> List[ast.AnnAssign]:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef) and node.name == "EngineStats":
            return [
                stmt for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
    return []


def _snapshot_func(module) -> Optional[ast.FunctionDef]:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef) and node.name == "EngineStats":
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name == "snapshot":
                    return stmt
    return None


def _snapshot_is_dynamic(snap: ast.FunctionDef) -> bool:
    """True when snapshot() iterates ``fields(self)`` — the dynamic form
    that covers every field by construction."""
    for node in ast.walk(snap):
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id == "fields") or (
                isinstance(fn, ast.Attribute) and fn.attr == "fields"
            ):
                return True
    return False


def _snapshot_names(snap: ast.FunctionDef) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(snap):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            names.add(node.value)
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def _load_check_bench(root: str):
    path = os.path.join(root, CHECK_BENCH_PATH)
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("_dslint_check_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class CounterRegistryRule(Rule):
    rule_id = "R4"
    title = ("EngineStats fields, snapshot(), the docs counter tables and "
             "check_bench's schema must agree (no silent counter drift)")

    def check_project(self, project):
        types_mod = project.module(TYPES_PATH)
        if types_mod is None:
            return
        fields = _engine_stats_fields(types_mod)
        public = [f for f in fields if not f.target.id.startswith("_")]

        # 1. snapshot() coverage
        snap = _snapshot_func(types_mod)
        if snap is None:
            yield types_mod.finding(
                "R4", 1, "EngineStats has no snapshot() method — RESULTS/"
                "bench consumers read it")
        elif not _snapshot_is_dynamic(snap):
            named = _snapshot_names(snap)
            for f in public:
                if f.target.id not in named:
                    yield types_mod.finding(
                        "R4", f,
                        f"counter {f.target.id!r} is not covered by "
                        "snapshot() — it would silently vanish from "
                        "RESULTS.json and the bench report",
                    )

        # 2. docs coverage (backticked mention anywhere in serving.md)
        docs = project.read_text(DOCS_PATH)
        if docs is not None:
            for f in public:
                if f"`{f.target.id}`" not in docs:
                    yield types_mod.finding(
                        "R4", f,
                        f"counter {f.target.id!r} is in snapshot() but "
                        f"missing from the {DOCS_PATH} counter tables — "
                        "operators cannot interpret an undocumented "
                        "counter",
                    )

        # 3 + 4. check_bench schema cross-check and (absorbed) the
        # scenario<->test coverage + committed-report checks
        try:
            cb = _load_check_bench(project.root)
        except Exception as e:  # pragma: no cover - import failure is fatal drift
            yield types_mod.finding(
                "R4", 1, f"{CHECK_BENCH_PATH.replace(os.sep, '/')} failed "
                f"to load: {e}")
            return
        if cb is None:
            return
        field_names = {f.target.id for f in public}
        snapshot_derived = {"accepted_per_dispatch", "hydration_ticks"}
        derived = set(getattr(cb, "DERIVED_KEYS", ()))
        cb_rel = CHECK_BENCH_PATH.replace(os.sep, "/")
        for scenario, (_path, _engines, engine_keys, block_derived) in (
            getattr(cb, "SCENARIOS", {}) or {}
        ).items():
            for key in tuple(engine_keys) + tuple(block_derived):
                if key in field_names or key in snapshot_derived or key in derived:
                    continue
                yield Finding(
                    rule="R4", path=cb_rel, line=1,
                    message=(
                        f"scenario {scenario!r} requires key {key!r} which "
                        "is neither an EngineStats field, a snapshot()-"
                        "derived key, nor declared in DERIVED_KEYS — a "
                        "renamed/phantom counter"),
                    scope="SCENARIOS", anchor=f"{scenario}:{key}",
                )
        test_src = project.read_text(BENCH_TEST_PATH.replace(os.sep, "/"))
        if test_src is not None and hasattr(cb, "check_test_coverage"):
            for problem in cb.check_test_coverage(test_src):
                yield Finding(
                    rule="R4", path=cb_rel, line=1,
                    message=f"bench coverage: {problem}",
                    scope="coverage", anchor=problem,
                )
        report_text = project.read_text(BENCH_REPORT_PATH)
        if report_text is not None and hasattr(cb, "check_report"):
            import json as _json
            try:
                report = _json.loads(report_text)
            except ValueError:
                report = None
                yield Finding(
                    rule="R4", path=BENCH_REPORT_PATH, line=1,
                    message=f"committed {BENCH_REPORT_PATH} is not valid JSON",
                    scope="report", anchor="json",
                )
            if report is not None:
                for problem in cb.check_report(report):
                    yield Finding(
                        rule="R4", path=BENCH_REPORT_PATH, line=1,
                        message=f"bench report schema: {problem}",
                        scope="report", anchor=problem,
                    )
