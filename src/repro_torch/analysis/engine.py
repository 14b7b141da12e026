"""Rule engine: file walking, AST parsing, pragmas, baseline, reporting.

The port's copy of ``repro.analysis.engine``: the same fingerprint,
pragma grammar, R0 hygiene and stale-baseline logic, over
``src/repro_torch/``.

The engine is rule-agnostic.  A rule is an object with

- ``rule_id``    — ``"R1"`` ... (``"R0"`` is reserved for the engine's
  own pragma/baseline hygiene findings);
- ``title``      — one line for ``--list-rules``;
- ``check_module(module, project)`` — per-file findings (default: none);
- ``check_project(project)``        — cross-file findings (default: none).

Findings carry a *fingerprint* — a content hash of (rule, path,
enclosing scope, normalized source line) — deliberately excluding the
line number, so a committed baseline survives unrelated edits above
the finding.

Suppression:

- ``# dslint: disable=R1(reason)`` on the finding's own line or on the
  enclosing ``def``/``class`` header line.  Several rules may share one
  pragma: ``disable=R1(reason),R5(other reason)``.  A pragma with a
  missing/empty reason or an unknown rule id is itself an R0 finding.
- ``baseline.json`` (committed next to this package): fingerprint ->
  ``{"rule", "path", "message", "justification"}``.  Entries without a
  non-empty justification are R0 findings; entries whose finding no
  longer fires are reported as stale (fix: ``--update-baseline``).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import subprocess
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")

# module roles drive rule scoping (R1 lease-path, R3 tick-path, ...).
# Keyed by path relative to the repo root, forward slashes.
ROLE_BY_PATH: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/launch/serve.py": ("lease",),
    "src/repro_torch/serving/prefix_store.py": ("lease",),
    "src/repro_torch/core/worker.py": ("handler",),
    "src/repro_torch/serving/engine.py": ("tick",),
    "src/repro_torch/serving/scheduler.py": ("tick",),
    "src/repro_torch/serving/sampling.py": ("tick",),
    "src/repro_torch/serving/speculate.py": ("tick",),
    "src/repro_torch/serving/cache_manager.py": ("tick",),
    "src/repro_torch/serving/prefix_cache.py": ("tick",),
}

# a fixture/test file can claim roles explicitly in its first lines:
#   # dslint-role: lease,tick
_ROLE_RE = re.compile(r"#\s*dslint-role:\s*([\w,\s-]+)")
_PRAGMA_RE = re.compile(r"#\s*dslint:\s*disable=(.*)$")
# one disable item: R<digits> optionally followed by (reason)
_ITEM_RE = re.compile(r"(R\d+)\s*(?:\(([^()]*)\))?")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    # enclosing def/class qualname ("" at module level): part of the
    # fingerprint so identical lines in different functions stay distinct
    scope: str = ""
    # the normalized source line the finding anchors to (fingerprint input)
    anchor: str = ""

    @property
    def fingerprint(self) -> str:
        blob = "|".join((self.rule, self.path, self.scope, self.anchor))
        return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class ParsedModule:
    """One parsed source file plus the lookup maps rules need."""

    def __init__(self, root: str, relpath: str, source: str):
        self.root = root
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        # parent links (ast has none): rules climb these to find retry
        # wrappers, enclosing classes, loops, ...
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._dslint_parent = node  # type: ignore[attr-defined]
        self.roles: Set[str] = set(ROLE_BY_PATH.get(self.relpath, ()))
        for ln in self.lines[:5]:
            m = _ROLE_RE.search(ln)
            if m:
                self.roles |= {r.strip() for r in m.group(1).split(",") if r.strip()}
        # pragma map: 1-based line -> {rule_id -> reason-or-None}
        self.pragmas: Dict[int, Dict[str, Optional[str]]] = {}
        for i, ln in enumerate(self.lines, 1):
            m = _PRAGMA_RE.search(ln)
            if m:
                self.pragmas[i] = {
                    rid: (reason.strip() if reason is not None else None)
                    for rid, reason in _ITEM_RE.findall(m.group(1))
                }
        # scope intervals: (start, end, header_line, qualname) for every
        # def/class, innermost-last so lookups prefer the tightest scope
        self._scopes: List[Tuple[int, int, int, str]] = []
        self._collect_scopes(self.tree, ())
        self._scopes.sort(key=lambda s: (s[0], -s[1]))

    def _collect_scopes(self, node: ast.AST, qual: Tuple[str, ...]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                q = qual + (child.name,)
                end = getattr(child, "end_lineno", child.lineno) or child.lineno
                self._scopes.append((child.lineno, end, child.lineno, ".".join(q)))
                self._collect_scopes(child, q)
            else:
                self._collect_scopes(child, qual)

    # ------------------------------------------------------------ lookups
    def scope_of(self, line: int) -> str:
        """Innermost def/class qualname containing ``line`` ("" = module)."""
        best = ""
        for start, end, _hdr, qual in self._scopes:
            if start <= line <= end:
                best = qual
        return best

    def scope_headers(self, line: int) -> List[int]:
        """Header lines of every def/class enclosing ``line``, innermost
        last — the lines a pragma may sit on besides the finding's own."""
        return [hdr for start, end, hdr, _q in self._scopes if start <= line <= end]

    def anchor_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return " ".join(self.lines[line - 1].split())
        return ""

    def finding(self, rule: str, node_or_line, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(
            rule=rule,
            path=self.relpath,
            line=int(line),
            message=message,
            scope=self.scope_of(int(line)),
            anchor=self.anchor_text(int(line)),
        )

    def pragma_for(self, line: int, rule: str) -> Optional[Tuple[int, Optional[str]]]:
        """The pragma suppressing ``rule`` at ``line``: checks the line
        itself, then enclosing def/class headers.  Returns (pragma line,
        reason) or None."""
        for cand in [line] + self.scope_headers(line):
            rules = self.pragmas.get(cand)
            if rules is not None and rule in rules:
                return cand, rules[rule]
        return None


class Project:
    """The parsed tree handed to rules.

    ``modules`` maps repo-relative path -> :class:`ParsedModule` for every
    lintable file.  ``root`` is the repo root: project rules locate their
    registries (``docs/serving.md``, ``benchmarks_torch/check_bench.py``,
    ``tests/``) relative to it and must *skip quietly* when an anchor
    file is absent (fixture trees are minimal)."""

    def __init__(self, root: str, modules: Dict[str, ParsedModule]):
        self.root = root
        self.modules = modules
        self.errors: List[str] = []

    # convenience for rules ------------------------------------------------
    def module(self, relpath: str) -> Optional[ParsedModule]:
        return self.modules.get(relpath)

    def with_role(self, role: str) -> List[ParsedModule]:
        return [m for m in self.modules.values() if role in m.roles]

    def read_text(self, relpath: str) -> Optional[str]:
        path = os.path.join(self.root, relpath)
        try:
            with open(path, encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None


def _iter_py_files(base: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(
            d for d in dirnames if d not in ("__pycache__", ".git")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def load_project(
    root: str,
    paths: Optional[Sequence[str]] = None,
    *,
    src_prefix: str = os.path.join("src", "repro_torch"),
) -> Project:
    """Parse every ``.py`` under ``root/src/repro_torch`` (or just ``paths``,
    repo-relative).  Unparseable files become project errors, not crashes
    — a syntax error is pytest's job to report, not ours to mask."""
    root = os.path.abspath(root)
    files: List[str] = []
    if paths:
        files = [os.path.join(root, p) for p in paths]
    else:
        base = os.path.join(root, src_prefix)
        if os.path.isdir(base):
            files = list(_iter_py_files(base))
    modules: Dict[str, ParsedModule] = {}
    errors: List[str] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            errors.append(f"{rel}: unreadable ({e})")
            continue
        try:
            modules[rel] = ParsedModule(root, rel, source)
        except SyntaxError as e:
            errors.append(f"{rel}: syntax error at line {e.lineno}")
    project = Project(root, modules)
    project.errors = errors
    return project


def changed_files(root: str) -> List[str]:
    """Repo-relative ``src/repro_torch/**.py`` files differing from HEAD
    (tracked changes + untracked), for ``--changed`` fast mode."""
    out: Set[str] = set()
    for args in (
        ["git", "diff", "--name-only", "HEAD", "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            res = subprocess.run(
                args, cwd=root, capture_output=True, text=True, check=True
            )
        except (OSError, subprocess.CalledProcessError):
            return []  # not a git checkout: caller falls back to full run
        out |= {ln.strip() for ln in res.stdout.splitlines() if ln.strip()}
    return sorted(
        p for p in out
        if p.startswith("src/repro_torch/") and p.endswith(".py")
        and os.path.exists(os.path.join(root, p))
    )


# ------------------------------------------------------------------ baseline
def load_baseline(path: str) -> Dict[str, Dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    return data if isinstance(data, dict) else {}


def save_baseline(path: str, entries: Dict[str, Dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=2, sort_keys=True)
        f.write("\n")


@dataclass
class Report:
    """Outcome of one analysis run."""

    findings: List[Finding] = field(default_factory=list)  # unbaselined, unsuppressed
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)  # (finding, reason)
    baselined: List[Tuple[Finding, str]] = field(default_factory=list)  # (finding, justification)
    stale_baseline: List[str] = field(default_factory=list)  # fingerprints that no longer fire
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def render(self) -> str:
        out = [f.render() for f in self.findings]
        out += [f"[error] {e}" for e in self.errors]
        for fp in self.stale_baseline:
            out.append(
                f"[stale-baseline] {fp}: finding no longer fires — remove it "
                "(python -m repro_torch.analysis --update-baseline)"
            )
        n = len(self.findings)
        out.append(
            f"dslint: {n} finding(s), {len(self.suppressed)} pragma-suppressed, "
            f"{len(self.baselined)} baselined"
            + ("" if not self.stale_baseline else
               f", {len(self.stale_baseline)} stale baseline entr(y/ies)")
        )
        return "\n".join(out)


def _pragma_hygiene(module: ParsedModule, known_rules: Set[str]) -> List[Finding]:
    """R0: malformed pragmas — unknown rule id, or an empty reason."""
    findings = []
    for line, rules in sorted(module.pragmas.items()):
        for rid, reason in sorted(rules.items()):
            if rid not in known_rules and rid != "R0":
                findings.append(module.finding(
                    "R0", line, f"pragma disables unknown rule {rid!r}"))
            if not reason:
                findings.append(module.finding(
                    "R0", line,
                    f"pragma for {rid} has no reason — write why: "
                    "# dslint: disable=Rx(reason)"))
    return findings


def run_analysis(
    root: str,
    *,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence] = None,
    baseline_path: Optional[str] = None,
    project: Optional[Project] = None,
) -> Report:
    """Lint ``root`` and return a :class:`Report`.

    ``paths`` restricts *per-module* rules to those files; project-wide
    rules (counter drift, kernel parity, inert knobs) always run — they
    read a handful of registry files and are cheap."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = ALL_RULES
    if project is None:
        project = load_project(root, paths)
        if paths:
            # project rules need the registry modules even in --changed
            # mode: merge in the full tree for context, but only report
            # per-module findings for the selected paths
            full = load_project(root)
            for rel, mod in full.modules.items():
                project.modules.setdefault(rel, mod)
    selected = {p.replace(os.sep, "/") for p in paths} if paths else None

    known = {r.rule_id for r in rules}
    raw: List[Finding] = []
    for mod in project.modules.values():
        if selected is not None and mod.relpath not in selected:
            continue
        raw.extend(_pragma_hygiene(mod, known))
        for rule in rules:
            raw.extend(rule.check_module(mod, project))
    for rule in rules:
        raw.extend(rule.check_project(project))

    baseline = load_baseline(baseline_path or DEFAULT_BASELINE)
    report = Report(errors=list(project.errors))
    seen_fps: Set[str] = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        seen_fps.add(f.fingerprint)
        mod = project.module(f.path)
        pragma = mod.pragma_for(f.line, f.rule) if mod is not None else None
        if f.rule != "R0" and pragma is not None:
            _line, reason = pragma
            report.suppressed.append((f, reason or ""))
            continue
        entry = baseline.get(f.fingerprint)
        if entry is not None:
            justification = str(entry.get("justification", "")).strip()
            if justification:
                report.baselined.append((f, justification))
                continue
            report.findings.append(Finding(
                rule="R0", path=f.path, line=f.line, scope=f.scope,
                anchor=f.anchor,
                message=(f"baseline entry {f.fingerprint} has no written "
                         f"justification (covers: {f.message})"),
            ))
            continue
        report.findings.append(f)
    if selected is None:
        # stale entries are only decidable on a full run: a --changed run
        # simply did not look where the baselined finding lives
        report.stale_baseline = sorted(set(baseline) - seen_fps)
    return report


def update_baseline(
    root: str,
    *,
    justification: str,
    baseline_path: Optional[str] = None,
) -> Report:
    """Re-baseline: current unbaselined findings are added with
    ``justification``; stale entries are dropped.  Refuses an empty
    justification — the baseline exists to *record* why."""
    if not justification.strip():
        raise ValueError(
            "refusing to baseline without a justification "
            "(--justify 'why this finding is acceptable')"
        )
    path = baseline_path or DEFAULT_BASELINE
    report = run_analysis(root, baseline_path=path)
    entries = load_baseline(path)
    for fp in report.stale_baseline:
        entries.pop(fp, None)
    for f in report.findings:
        if f.rule == "R0":
            continue  # hygiene findings are never baselinable
        entries[f.fingerprint] = {
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
            "justification": justification.strip(),
        }
    save_baseline(path, entries)
    return report
