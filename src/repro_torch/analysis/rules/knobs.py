"""R7 — inert-knob refusal.

Motivating gap (found by an audit): ``DSConfig`` carried fields
(``ebs_vol_size_gb``, ``sqs_dead_letter_queue``) that were validated
and documented but consumed by nothing — an operator tuning them got
silent no-ops.  A config field must be *consumed* somewhere under
``src/repro_torch/`` outside ``core/config.py`` and ``analysis/``, or
*explicitly refused*: an entry in ``config.py``'s ``INERT_PAPER_FIELDS``
dict (paper-fidelity fields kept for CLI/doc parity, each with a
written reason).  The prefix ends in ``/``: ``src/repro/`` (the JAX
package) is never a consumer.

"Consumed" is a syntactic check, deliberately broad: the field name
appearing outside ``config.py`` as an attribute access (``cfg.field``),
a string literal (dict-driven plumbing), or a keyword argument.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules.common import Rule

CONFIG_PATH = "src/repro_torch/core/config.py"


def _dsconfig_fields(module):
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef) and node.name == "DSConfig":
            return [
                stmt for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and not stmt.target.id.startswith("_")
            ]
    return []


def _inert_registry(module):
    """Keys of config.py's module-level ``INERT_PAPER_FIELDS`` dict,
    or None when the registry is absent."""
    for stmt in module.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        else:
            continue
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        if "INERT_PAPER_FIELDS" not in names or not isinstance(stmt.value, ast.Dict):
            continue
        keys = {}
        for k, v in zip(stmt.value.keys, stmt.value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                reason = v.value if (
                    isinstance(v, ast.Constant) and isinstance(v.value, str)
                ) else ""
                keys[k.value] = reason
        return keys
    return None


def _consumers(project, field_name):
    """True if ``field_name`` is referenced outside core/config.py as an
    attribute access, a string literal, or a keyword argument."""
    for mod in project.modules.values():
        if mod.relpath == CONFIG_PATH or not mod.relpath.startswith(
            "src/repro_torch/"
        ):
            continue
        if mod.relpath.startswith("src/repro_torch/analysis/"):
            continue  # the linter's own sources don't count as consumers
        if field_name not in mod.source:
            continue  # cheap pre-filter before the AST pass
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and node.attr == field_name:
                return True
            if isinstance(node, ast.Constant) and node.value == field_name:
                return True
            if isinstance(node, ast.keyword) and node.arg == field_name:
                return True
    return False


class InertKnobRule(Rule):
    rule_id = "R7"
    title = ("every DSConfig field must be consumed somewhere in "
             "src/repro_torch or explicitly refused in INERT_PAPER_FIELDS")

    def check_project(self, project):
        cfg_mod = project.module(CONFIG_PATH)
        if cfg_mod is None:
            return
        fields = _dsconfig_fields(cfg_mod)
        inert = _inert_registry(cfg_mod)
        inert_keys = set(inert or {})
        field_names = {f.target.id for f in fields}
        for f in fields:
            name = f.target.id
            if name in inert_keys:
                if not (inert or {}).get(name, "").strip():
                    yield cfg_mod.finding(
                        "R7", f,
                        f"INERT_PAPER_FIELDS[{name!r}] has no written reason "
                        "— the registry exists to record *why* a knob is "
                        "allowed to be inert",
                    )
                continue
            if not _consumers(project, name):
                yield cfg_mod.finding(
                    "R7", f,
                    f"DSConfig.{name} is consumed by nothing under "
                    "src/repro_torch/ — an operator tuning it gets a silent "
                    "no-op; wire it up or add it to INERT_PAPER_FIELDS "
                    "with a reason",
                )
        # stale registry entries: refusing a field that no longer exists
        for name in sorted(inert_keys - field_names):
            yield Finding(
                rule="R7", path=CONFIG_PATH, line=1,
                message=(f"INERT_PAPER_FIELDS entry {name!r} names a field "
                         "that is no longer on DSConfig — drop it"),
                scope="INERT_PAPER_FIELDS", anchor=name,
            )
