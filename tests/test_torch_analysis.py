"""dslint for the port (repro_torch.analysis): every test of
tests/test_analysis.py mirrored over ``src/repro_torch/`` paths, the
port-only cases (torch's global-generator draws in R3, R7's prefix, R4's
bench anchors), and the linter held to ``repro.analysis`` finding for
finding: on every shared fixture, on the R4/R6/R7 trees below, and on
both packages' whole trees relocated under each other's prefix.

The tolerance is exact equality of (rule, path, line, scope, anchor,
message) once the port's paths, test-file names and "torch" are mapped
to the reference's, and of the suppressed and baselined counts."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from repro.analysis import run_analysis as reference_run_analysis
from repro.analysis.engine import update_baseline as reference_update_baseline
from repro.analysis.rules import ALL_RULES as REFERENCE_RULES
from repro_torch.analysis import run_analysis
from repro_torch.analysis.engine import changed_files, update_baseline
from repro_torch.analysis.rules import ALL_RULES, counters, kernels, knobs

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "dslint")
JUSTIFY = "known, tracked elsewhere"

# registry files the project rules read, by role: the reference's and the
# port's.  The R4 bench anchors of the port are its benchmark's own files.
REF_ANCHORS = {
    "docs": "docs/serving.md",
    "kernel_tests": "tests/test_kernels.py",
    "check_bench": "benchmarks/check_bench.py",
    "bench_test": "tests/test_bench_serving.py",
    "bench_report": "BENCH_serving.json",
}
PORT_ANCHORS = {
    "docs": "docs/serving.md",
    "kernel_tests": "tests/test_torch_kernels.py",
    "check_bench": "benchmarks_torch/check_bench.py",
    "bench_test": "tests/test_torch_bench_serving.py",
    "bench_report": "BENCH_serving_torch.json",
}
# port text -> reference text, longest first
_TO_REFERENCE = sorted(
    [(PORT_ANCHORS[k], REF_ANCHORS[k]) for k in REF_ANCHORS
     if PORT_ANCHORS[k] != REF_ANCHORS[k]]
    + [("src/repro_torch/", "src/repro/"), ("plain-torch", "plain-jnp")],
    key=lambda pair: -len(pair[0]),
)


def fixture(name: str) -> str:
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        return f.read()


def repo_text(rel: str) -> str:
    with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as f:
        return f.read()


def write_tree(root, files):
    for rel, source in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source, encoding="utf-8")


def lint_tree(tmp_path, files, **kwargs):
    """Write ``files`` (relpath -> source) under a fresh root and lint it
    with the port's linter and an empty baseline."""
    write_tree(tmp_path, files)
    kwargs.setdefault("baseline_path", str(tmp_path / "baseline.json"))
    return run_analysis(str(tmp_path), **kwargs)


def rules_fired(report):
    return sorted({f.rule for f in report.findings})


def to_reference(text: str) -> str:
    for port, ref in _TO_REFERENCE:
        text = text.replace(port, ref)
    return text


def normalized(report, *, port: bool):
    """(rule, path, line, scope, anchor, message) of every finding, in the
    reference's words, and the suppressed/baselined/stale counts."""
    fix = to_reference if port else (lambda s: s)
    rows = sorted(
        (f.rule, fix(f.path), f.line, f.scope, f.anchor, fix(f.message))
        for f in report.findings
    )
    suppressed = sorted(
        (f.rule, fix(f.path), f.line, f.scope, f.anchor, reason)
        for f, reason in report.suppressed
    )
    return rows, suppressed, len(report.baselined), len(report.stale_baseline)


def both_trees(tmp_path, pkg_files, anchors=None):
    """The same tree twice: under ``src/repro/`` with the reference's
    anchor paths, and under ``src/repro_torch/`` with the port's."""
    roots = {}
    for name, prefix, anchor_paths in (
        ("reference", "src/repro/", REF_ANCHORS),
        ("port", "src/repro_torch/", PORT_ANCHORS),
    ):
        root = tmp_path / name
        files = {prefix + rel: src for rel, src in pkg_files.items()}
        files.update({anchor_paths[k]: src for k, src in (anchors or {}).items()})
        write_tree(root, files)
        roots[name] = root
    return roots["reference"], roots["port"]


def assert_held_to_reference(tmp_path, pkg_files, anchors=None):
    """Both linters on the same tree: equal findings with an empty
    baseline, and equal baselined counts after each re-baselines it."""
    ref_root, port_root = both_trees(tmp_path, pkg_files, anchors)
    ref_bl, port_bl = str(tmp_path / "ref_bl.json"), str(tmp_path / "port_bl.json")
    ref = reference_run_analysis(str(ref_root), baseline_path=ref_bl)
    port = run_analysis(str(port_root), baseline_path=port_bl)
    assert normalized(port, port=True) == normalized(ref, port=False), (
        f"reference:\n{ref.render()}\nport:\n{port.render()}")
    if any(f.rule != "R0" for f in ref.findings):
        reference_update_baseline(str(ref_root), justification=JUSTIFY,
                                  baseline_path=ref_bl)
        update_baseline(str(port_root), justification=JUSTIFY,
                        baseline_path=port_bl)
        ref = reference_run_analysis(str(ref_root), baseline_path=ref_bl)
        port = run_analysis(str(port_root), baseline_path=port_bl)
        assert normalized(port, port=True) == normalized(ref, port=False)
        assert len(port.baselined) == len(ref.baselined) > 0
        with open(ref_bl) as f:
            ref_entries = sorted(
                (e["rule"], e["path"], e["message"]) for e in json.load(f).values())
        with open(port_bl) as f:
            port_entries = sorted(
                (e["rule"], to_reference(e["path"]), to_reference(e["message"]))
                for e in json.load(f).values())
        assert port_entries == ref_entries
    return ref, port


# --------------------------------------------------------------- rule catalog
def test_rule_ids_are_unique_and_titled():
    ids = [r.rule_id for r in ALL_RULES]
    assert len(ids) == len(set(ids))
    assert all(r.title for r in ALL_RULES)
    assert "R0" not in ids  # reserved for engine hygiene findings
    # the reference's seven rules, in its order
    assert ids == [r.rule_id for r in REFERENCE_RULES]


def test_anchor_paths_are_the_ports_own():
    assert counters.TYPES_PATH == "src/repro_torch/serving/types.py"
    assert counters.DOCS_PATH == PORT_ANCHORS["docs"]
    assert counters.CHECK_BENCH_PATH.replace(os.sep, "/") == PORT_ANCHORS["check_bench"]
    assert counters.BENCH_TEST_PATH.replace(os.sep, "/") == PORT_ANCHORS["bench_test"]
    assert counters.BENCH_REPORT_PATH == PORT_ANCHORS["bench_report"]
    assert kernels.OPS_PATH == "src/repro_torch/kernels/ops.py"
    assert kernels.REF_PATH == "src/repro_torch/kernels/ref.py"
    assert kernels.TESTS_PATH.replace(os.sep, "/") == PORT_ANCHORS["kernel_tests"]
    assert knobs.CONFIG_PATH == "src/repro_torch/core/config.py"


# ------------------------------------------------------------- R1 fixtures
def test_r1_trips_on_bare_lease_ops(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r1_bad.py")}
    )
    r1 = [f for f in report.findings if f.rule == "R1"]
    assert len(r1) == 2, report.render()
    assert any("store.put_json" in f.message for f in r1)
    assert any("rq.delete" in f.message for f in r1)


def test_r1_passes_retry_wrapped_ops(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r1_good.py")}
    )
    assert report.ok, report.render()


def test_r1_ignores_modules_without_lease_role(tmp_path):
    source = fixture("r1_bad.py").replace("# dslint-role: lease", "")
    report = lint_tree(tmp_path, {"src/repro_torch/fix.py": source})
    assert report.ok, report.render()


# ------------------------------------------------------------- R2 fixtures
def test_r2_trips_on_ack_before_put(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r2_bad.py")}
    )
    assert rules_fired(report) == ["R2"], report.render()


def test_r2_passes_put_then_ack_and_cross_loop_order(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r2_good.py")}
    )
    assert report.ok, report.render()


# ------------------------------------------------------------- R3 fixtures
def test_r3_trips_on_clock_rng_and_set_iteration(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r3_bad.py")}
    )
    r3 = [f for f in report.findings if f.rule == "R3"]
    assert len(r3) == 3, report.render()
    blob = " ".join(f.message for f in r3)
    assert "time.time" in blob and "random.random" in blob and "seen" in blob


def test_r3_passes_seeded_and_sorted(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r3_good.py")}
    )
    assert report.ok, report.render()


TORCH_TICK = "# dslint-role: tick\nimport torch\n\n\ndef tick(x, p, w, g):\n    return {}\n"


@pytest.mark.parametrize("draw", [
    "torch.rand(3)", "x.uniform_()", "torch.randn(2, 3)", "torch.randint(0, 9, (3,))",
    "torch.randperm(5)", "torch.multinomial(p, 1)", "torch.bernoulli(p)",
    "torch.normal(0.0, 1.0, (3,))", "torch.rand_like(x)", "torch.randn_like(x)",
    "torch.randint_like(x, 9)", "x.normal_()", "x.exponential_()", "x.random_()",
    "x.bernoulli_(0.5)", "torch.nn.init.normal_(w)",
])
def test_r3_trips_on_torch_global_generator_draws(tmp_path, draw):
    """The port's addition to R3: a draw from torch's global generator on
    a tick path cannot be replayed."""
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": TORCH_TICK.replace("{}", draw)}
    )
    r3 = [f for f in report.findings if f.rule == "R3"]
    assert len(r3) == 1 and "torch's global generator" in r3[0].message, report.render()
    assert r3[0].line == 6


@pytest.mark.parametrize("draw", [
    "torch.rand(3, generator=g)", "x.uniform_(generator=g)",
    "torch.multinomial(p, 1, generator=g)", "torch.Generator().manual_seed(0)",
    "torch.zeros(3)", "x.add_(1)",
])
def test_r3_passes_seeded_torch_draws(tmp_path, draw):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": TORCH_TICK.replace("{}", draw)}
    )
    assert report.ok, report.render()


def test_r3_torch_draws_only_on_tick_paths(tmp_path):
    source = TORCH_TICK.replace("{}", "torch.rand(3)").replace("# dslint-role: tick", "")
    report = lint_tree(tmp_path, {"src/repro_torch/fix.py": source})
    assert report.ok, report.render()


# ------------------------------------------------------------- R5 fixtures
def test_r5_trips_on_unlocked_shared_writes(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r5_bad.py")}
    )
    r5 = [f for f in report.findings if f.rule == "R5"]
    assert len(r5) == 2, report.render()  # one per unguarded side
    assert all("pending" in f.message for f in r5)


def test_r5_passes_locked_and_single_writer(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r5_good.py")}
    )
    assert report.ok, report.render()


R5_GLOBALS = "# dslint-role: lease\nCACHE = {}\n"
R5_GLOBALS_SUPPRESSED = R5_GLOBALS.replace(
    "CACHE = {}", "CACHE = {}  # dslint: disable=R5(per-key ownership)"
)


def test_r5_flags_module_globals_in_lease_modules(tmp_path):
    report = lint_tree(tmp_path, {"src/repro_torch/fix.py": R5_GLOBALS})
    assert rules_fired(report) == ["R5"], report.render()
    report = lint_tree(tmp_path, {"src/repro_torch/fix.py": R5_GLOBALS_SUPPRESSED})
    assert report.ok, report.render()


# --------------------------------------------------------- R4 (project rule)
TYPES_EXPLICIT = '''
from dataclasses import dataclass

@dataclass
class EngineStats:
    ticks: int = 0
    tokens_emitted: int = 0
    _scratch: int = 0

    def snapshot(self):
        return {"ticks": self.ticks}
'''

TYPES_DYNAMIC = '''
from dataclasses import dataclass, fields

@dataclass
class EngineStats:
    ticks: int = 0
    tokens_emitted: int = 0
    _scratch: int = 0

    def snapshot(self):
        return {f.name: getattr(self, f.name) for f in fields(self)
                if not f.name.startswith("_")}
'''

DOCS_BOTH = "counters: `ticks` and `tokens_emitted`\n"
PHANTOM_CHECK_BENCH = (
    "DERIVED_KEYS = frozenset()\n"
    'SCENARIOS = {"s": (("engines",), ("e",), ("phantom_counter",), ())}\n'
)


def test_r4_trips_on_counter_dropped_from_snapshot(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": TYPES_EXPLICIT,
        "docs/serving.md": DOCS_BOTH,
    })
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert len(r4) == 1 and "tokens_emitted" in r4[0].message, report.render()
    assert "snapshot" in r4[0].message


def test_r4_trips_on_undocumented_counter(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": TYPES_DYNAMIC,
        "docs/serving.md": "counters: `ticks`\n",
    })
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert len(r4) == 1 and "tokens_emitted" in r4[0].message, report.render()
    assert "docs/serving.md" in r4[0].message


def test_r4_passes_agreeing_registries(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": TYPES_DYNAMIC,
        "docs/serving.md": DOCS_BOTH,
    })
    assert report.ok, report.render()


def test_r4_trips_on_phantom_bench_schema_key(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": TYPES_DYNAMIC,
        "docs/serving.md": DOCS_BOTH,
        PORT_ANCHORS["check_bench"]: PHANTOM_CHECK_BENCH,
    })
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert len(r4) == 1 and "phantom_counter" in r4[0].message, report.render()
    assert r4[0].path == PORT_ANCHORS["check_bench"]


def test_r4_ignores_the_reference_bench_schema(tmp_path):
    """The reference's ``benchmarks/check_bench.py`` is not the port's
    anchor: a phantom key there is not the port's drift."""
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": TYPES_DYNAMIC,
        "docs/serving.md": DOCS_BOTH,
        REF_ANCHORS["check_bench"]: PHANTOM_CHECK_BENCH,
    })
    assert report.ok, report.render()


def _load_reference_check_bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cb_torch_r4", os.path.join(REPO_ROOT, "benchmarks", "check_bench.py")
    )
    cb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cb)
    return cb


def test_real_bench_schema_keys_all_classified():
    """Direct form of the R4 invariant against the port: every key the
    reference's check_bench requires is a field of the port's
    EngineStats, a snapshot()-derived key, or a declared DERIVED_KEYS
    member — the schema the port's benchmark will copy."""
    import dataclasses

    from repro_torch.serving.types import EngineStats

    cb = _load_reference_check_bench()
    fields = {
        f.name for f in dataclasses.fields(EngineStats)
        if not f.name.startswith("_")
    }
    allowed = fields | {"accepted_per_dispatch", "hydration_ticks"} | set(
        cb.DERIVED_KEYS
    )
    for name, (_p, _e, engine_keys, derived) in cb.SCENARIOS.items():
        unclassified = (set(engine_keys) | set(derived)) - allowed
        assert not unclassified, f"scenario {name}: {sorted(unclassified)}"


def _bench_anchor_tree(**overrides):
    """The port's real types.py and docs, with the reference's bench
    schema checker, its smoke test and its committed report at the port's
    anchor paths (the shape the port's benchmark will commit)."""
    files = {
        "src/repro_torch/serving/types.py": repo_text("src/repro_torch/serving/types.py"),
        "docs/serving.md": repo_text("docs/serving.md"),
        PORT_ANCHORS["check_bench"]: repo_text(REF_ANCHORS["check_bench"]),
        PORT_ANCHORS["bench_test"]: repo_text(REF_ANCHORS["bench_test"]),
        PORT_ANCHORS["bench_report"]: repo_text(REF_ANCHORS["bench_report"]),
    }
    files.update(overrides)
    return files


@pytest.mark.parametrize("drift", ["field", "coverage", "report"])
def test_r4_bench_anchors_run_parts_3_and_4(tmp_path, drift):
    """Parts 3-4 read the port's anchors: a counter renamed in the port's
    EngineStats, a scenario the smoke test forgets, and a report that is
    not JSON each fail the lint."""
    types_src = repo_text("src/repro_torch/serving/types.py")
    if drift == "field":
        field = "    prefill_dispatches: int = 0\n"
        assert field in types_src
        overrides = {
            "src/repro_torch/serving/types.py": types_src.replace(
                field, field.replace("dispatches", "calls")),
            "docs/serving.md": repo_text("docs/serving.md") + "`prefill_calls`\n",
        }
        where, needle = PORT_ANCHORS["check_bench"], "'prefill_dispatches'"
    elif drift == "coverage":
        test_src = repo_text(REF_ANCHORS["bench_test"])
        overrides = {PORT_ANCHORS["bench_test"]: re.sub(
            r"[\"']disaggregation[\"']", "DISAGG", test_src)}
        where, needle = PORT_ANCHORS["check_bench"], "bench coverage"
    else:
        overrides = {PORT_ANCHORS["bench_report"]: "{not json"}
        where, needle = PORT_ANCHORS["bench_report"], "not valid JSON"
    report = lint_tree(tmp_path, _bench_anchor_tree(**overrides))
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert any(f.path == where and needle in f.message for f in r4), report.render()


# --------------------------------------------------------- R6 (project rule)
OPS_FIXTURE = "def myop(x):\n    return x\n\n\ndef _helper(x):\n    return x\n"
REF_WITHOUT_ORACLES = "def myop_reference(x):\n    return x\n"
REF_WITH_ORACLES = (
    "def myop_reference(x):\n    return x\n\n\n"
    'ORACLES = {"myop": myop_reference}\n'
)


def test_r6_trips_on_missing_oracle_and_test(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/kernels/ops.py": OPS_FIXTURE,
        "src/repro_torch/kernels/ref.py": REF_WITHOUT_ORACLES,
        "tests/test_torch_kernels.py": "def test_other():\n    pass\n",
    })
    r6 = [f for f in report.findings if f.rule == "R6"]
    msgs = " | ".join(f.message for f in r6)
    assert "no module-level ORACLES" in msgs, report.render()
    assert "no ORACLES entry" in msgs and "plain-torch" in msgs
    assert "never referenced in tests/test_torch_kernels.py" in msgs


def test_r6_passes_registered_and_tested_kernel(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/kernels/ops.py": OPS_FIXTURE,
        "src/repro_torch/kernels/ref.py": REF_WITH_ORACLES,
        "tests/test_torch_kernels.py": "def test_myop():\n    assert myop\n",
    })
    assert report.ok, report.render()


def test_r6_reads_the_ports_test_file(tmp_path):
    """A parity test in the reference's tests/test_kernels.py does not
    cover a port kernel."""
    report = lint_tree(tmp_path, {
        "src/repro_torch/kernels/ops.py": OPS_FIXTURE,
        "src/repro_torch/kernels/ref.py": REF_WITH_ORACLES,
        "tests/test_torch_kernels.py": "def test_other():\n    pass\n",
        "tests/test_kernels.py": "def test_myop():\n    assert myop\n",
    })
    assert [f.rule for f in report.findings] == ["R6"], report.render()


# --------------------------------------------------------- R7 (project rule)
CONFIG_FIXTURE = '''
from dataclasses import dataclass

INERT_PAPER_FIELDS = {
    "dead_knob": "paper parity: nothing to size in the simulation",
    "vanished": "covers a field that no longer exists",
}

@dataclass
class DSConfig:
    live_knob: int = 1
    dead_knob: int = 2
    ghost_knob: int = 3
'''
R7_USER = "def use(cfg):\n    return cfg.live_knob\n"
R7_STRING_USER = R7_USER + (
    'def use(d, **kw):\n'
    '    a = d["ghost_knob"]\n'
    '    return a\n'
)


def test_r7_trips_on_inert_and_stale_entries(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/core/config.py": CONFIG_FIXTURE,
        "src/repro_torch/core/user.py": R7_USER,
    })
    r7 = [f for f in report.findings if f.rule == "R7"]
    msgs = " | ".join(f.message for f in r7)
    assert "ghost_knob" in msgs, report.render()  # consumed nowhere
    assert "vanished" in msgs  # stale refusal entry
    assert "dead_knob" not in msgs  # refused with a reason: fine
    assert "live_knob" not in msgs  # consumed: fine


def test_r7_consumption_via_string_or_kwarg_counts(tmp_path):
    report = lint_tree(tmp_path, {
        "src/repro_torch/core/config.py": CONFIG_FIXTURE,
        "src/repro_torch/core/user.py": R7_STRING_USER,
    })
    msgs = " | ".join(f.message for f in report.findings if f.rule == "R7")
    assert "ghost_knob" not in msgs, report.render()


@pytest.mark.parametrize("consumer", [
    "src/repro/core/user.py", "src/repro_torch/analysis/user.py",
])
def test_r7_consumers_are_the_ports_own_modules(tmp_path, consumer):
    """Neither the JAX package (``src/repro/`` shares the port's prefix
    but for its slash) nor the linter's own sources consume a knob."""
    user = "def use(cfg):\n    return cfg.live_knob, cfg.ghost_knob\n"
    report = lint_tree(tmp_path, {
        "src/repro_torch/core/config.py": CONFIG_FIXTURE,
        "src/repro_torch/core/user.py": R7_USER,
        consumer: user,
    }, paths=["src/repro_torch/core/config.py", consumer])
    msgs = " | ".join(f.message for f in report.findings if f.rule == "R7")
    assert "ghost_knob" in msgs, report.render()


# ------------------------------------------------------- pragmas & baseline
def test_pragma_suppresses_but_hygiene_fires(tmp_path):
    report = lint_tree(
        tmp_path, {"src/repro_torch/fix.py": fixture("r0_bad.py")}
    )
    # the R1 finding is suppressed by the (malformed) pragma...
    assert not any(f.rule == "R1" for f in report.findings)
    assert len(report.suppressed) == 1
    # ...but the empty reason and the unknown rule id are R0 findings
    r0 = [f for f in report.findings if f.rule == "R0"]
    msgs = " | ".join(f.message for f in r0)
    assert "no reason" in msgs and "R99" in msgs, report.render()


PRAGMA_ON_HEADER = (
    "# dslint-role: lease\n"
    "def probe(store, key):  # dslint: disable=R1(probe is best-effort)\n"
    "    return store.exists(key)\n"
)


def test_pragma_on_def_header_covers_the_body(tmp_path):
    report = lint_tree(tmp_path, {"src/repro_torch/fix.py": PRAGMA_ON_HEADER})
    assert report.ok, report.render()
    assert len(report.suppressed) == 1


def test_baseline_workflow_roundtrip(tmp_path):
    write_tree(tmp_path, {"src/repro_torch/fix.py": fixture("r1_bad.py")})
    bl = tmp_path / "baseline.json"

    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    assert len(report.findings) == 2

    with pytest.raises(ValueError):
        update_baseline(str(tmp_path), justification="  ",
                        baseline_path=str(bl))

    update_baseline(str(tmp_path), justification=JUSTIFY,
                    baseline_path=str(bl))
    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    assert report.ok and len(report.baselined) == 2, report.render()

    # fingerprints survive unrelated edits above the finding
    p = tmp_path / "src/repro_torch/fix.py"
    p.write_text("# new leading comment\n" + p.read_text(), encoding="utf-8")
    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    assert report.ok and len(report.baselined) == 2, report.render()

    # fixing the violations makes the entries stale (full runs only)
    p.write_text(fixture("r1_good.py"), encoding="utf-8")
    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    assert not report.findings and len(report.stale_baseline) == 2
    assert "python -m repro_torch.analysis --update-baseline" in report.render()
    update_baseline(str(tmp_path), justification="sweep stale",
                    baseline_path=str(bl))
    assert json.loads(bl.read_text()) == {}


def test_baseline_entry_without_justification_is_a_finding(tmp_path):
    write_tree(tmp_path, {"src/repro_torch/fix.py": fixture("r2_bad.py")})
    bl = tmp_path / "baseline.json"
    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    (fp,) = [f.fingerprint for f in report.findings]
    bl.write_text(json.dumps({fp: {"rule": "R2", "justification": ""}}))
    report = run_analysis(str(tmp_path), baseline_path=str(bl))
    assert rules_fired(report) == ["R0"], report.render()
    assert "no written" in report.findings[0].message


# ------------------------------------------------------ paths / changed mode
def test_paths_mode_limits_module_findings(tmp_path):
    files = {
        "src/repro_torch/bad.py": fixture("r1_bad.py"),
        "src/repro_torch/other.py": fixture("r3_bad.py"),
    }
    report = lint_tree(tmp_path, files, paths=["src/repro_torch/other.py"])
    assert rules_fired(report) == ["R3"], report.render()
    # stale-baseline detection is deferred on partial runs
    assert report.stale_baseline == []


def test_full_run_walks_only_the_port(tmp_path):
    """A tree holding both packages: the port's linter reads the port."""
    report = lint_tree(tmp_path, {
        "src/repro/bad.py": fixture("r1_bad.py"),
        "src/repro_torch/other.py": fixture("r3_bad.py"),
    })
    assert rules_fired(report) == ["R3"], report.render()
    assert {f.path for f in report.findings} == {"src/repro_torch/other.py"}


def test_changed_files_runs_on_the_repo():
    out = changed_files(REPO_ROOT)
    assert isinstance(out, list)
    assert all(p.startswith("src/repro_torch/") for p in out)


def test_changed_files_picks_the_ports_edits(tmp_path):
    """``--changed`` lists edited and untracked files of the port and
    nothing of the reference."""
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@t",
           "-c", "commit.gpgsign=false"]
    write_tree(tmp_path, {"src/repro/a.py": "A = 1\n",
                          "src/repro_torch/a.py": "A = 1\n"})
    for args in (["init", "-q"], ["add", "-A"], ["commit", "-qm", "seed"]):
        subprocess.run(git + args, cwd=tmp_path, check=True, capture_output=True)
    write_tree(tmp_path, {"src/repro/a.py": "A = 2\n", "src/repro/b.py": "B = 1\n",
                          "src/repro_torch/a.py": "A = 2\n",
                          "src/repro_torch/b.py": "B = 1\n"})
    assert changed_files(str(tmp_path)) == ["src/repro_torch/a.py",
                                            "src/repro_torch/b.py"]


def test_cli_list_rules_and_clean_run(capsys, tmp_path):
    from repro_torch.analysis.__main__ import _default_root, main

    assert _default_root() == REPO_ROOT
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in ALL_RULES:
        assert rule.rule_id in listed
    assert main([]) == 0
    assert "0 finding(s), 4 pragma-suppressed, 4 baselined" in capsys.readouterr().out
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert main(["--baseline", str(empty)]) == 1
    assert main(["--update-baseline", "--baseline", str(empty)]) == 2


# ------------------------------------------------------------ tier-1 gates
def test_repo_tree_is_clean():
    """THE tier-1 gate for the port: its real tree has zero unbaselined
    findings and no stale baseline entries."""
    report = run_analysis(REPO_ROOT)
    assert report.ok, report.render()
    assert report.stale_baseline == [], report.render()
    # the TTL sweep's four calls under three entries: its two
    # ``self.store.delete(info.key)`` lines share one fingerprint
    assert len(report.baselined) == 4
    with open(os.path.join(REPO_ROOT, "src/repro_torch/analysis/baseline.json")) as f:
        entries = json.load(f)
    assert len(entries) == 3 and all(e["justification"].strip() for e in entries.values())


def test_empty_baseline_leaves_exactly_the_ttl_sweep(tmp_path):
    """With an empty baseline the port's tree reports the TTL sweep's
    four bare list/delete calls and nothing else, with the four pragmas
    (three R5 module caches in launch/serve.py, publish's R1) suppressing
    — what the reference reports on its own tree."""
    empty = str(tmp_path / "empty.json")
    report = run_analysis(REPO_ROOT, baseline_path=empty)
    assert [(f.rule, f.path, f.scope) for f in report.findings] == [
        ("R1", "src/repro_torch/serving/prefix_store.py", "PrefixStore.sweep")
    ] * 4, report.render()
    assert sorted((f.rule, f.path) for f, _ in report.suppressed) == [
        ("R1", "src/repro_torch/serving/prefix_store.py")
    ] + [("R5", "src/repro_torch/launch/serve.py")] * 3
    assert all(reason for _, reason in report.suppressed)
    ref = reference_run_analysis(REPO_ROOT, baseline_path=empty)
    assert (len(ref.findings), len(ref.suppressed)) == (4, 4)


def test_acceptance_reintroduced_bare_prefix_store_put(tmp_path):
    """Stripping the publish pragma (= re-introducing an unretried put)
    must fail the lint."""
    source = repo_text("src/repro_torch/serving/prefix_store.py")
    assert "# dslint: disable=R1" in source
    stripped = re.sub(r"\s*# dslint: disable=R1[^\n]*", "", source)
    report = lint_tree(
        tmp_path, {"src/repro_torch/serving/prefix_store.py": stripped}
    )
    r1 = [f for f in report.findings if f.rule == "R1"]
    assert any("put_bytes" in f.message for f in r1), report.render()


def test_acceptance_counter_dropped_from_docs(tmp_path):
    """Un-documenting a real counter of the port must fail the lint."""
    report = lint_tree(tmp_path, {
        "src/repro_torch/serving/types.py": repo_text("src/repro_torch/serving/types.py"),
        "docs/serving.md": repo_text("docs/serving.md").replace("`ticks`", "ticks"),
    })
    r4 = [f for f in report.findings if f.rule == "R4"]
    assert any("'ticks'" in f.message for f in r4), report.render()


def test_lint_reads_nothing_of_the_reference(tmp_path):
    """The port's tree beside a poisoned reference (a schema checker that
    raises when loaded, a syntax error, a report that is not JSON): the
    port's run is as clean as on the repo."""
    shutil.copytree(os.path.join(REPO_ROOT, "src", "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    write_tree(tmp_path, {
        "docs/serving.md": repo_text("docs/serving.md"),
        PORT_ANCHORS["kernel_tests"]: repo_text(PORT_ANCHORS["kernel_tests"]),
        REF_ANCHORS["check_bench"]: "raise RuntimeError('reference loaded')\n",
        REF_ANCHORS["bench_test"]: "",
        REF_ANCHORS["bench_report"]: "{not json",
        REF_ANCHORS["kernel_tests"]: "",
        "src/repro/serving/types.py": "def (\n",
    })
    bl = str(tmp_path / "src/repro_torch/analysis/baseline.json")
    here = run_analysis(str(tmp_path), baseline_path=bl)
    repo = run_analysis(REPO_ROOT)
    assert here.ok and not here.stale_baseline, here.render()
    assert normalized(here, port=True) == normalized(repo, port=True)


# ------------------------------------- held to the reference, finding for finding
FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py"))

# tree name -> (package files relative to src/<package>/, anchors by role)
TREES = {
    "r1_no_role": ({"fix.py": fixture("r1_bad.py").replace("# dslint-role: lease", "")}, {}),
    "r5_globals": ({"fix.py": R5_GLOBALS}, {}),
    "r5_globals_suppressed": ({"fix.py": R5_GLOBALS_SUPPRESSED}, {}),
    "pragma_on_header": ({"fix.py": PRAGMA_ON_HEADER}, {}),
    "paths_two_modules": ({"bad.py": fixture("r1_bad.py"),
                           "other.py": fixture("r3_bad.py")}, {}),
    "r4_explicit": ({"serving/types.py": TYPES_EXPLICIT}, {"docs": DOCS_BOTH}),
    "r4_undocumented": ({"serving/types.py": TYPES_DYNAMIC},
                        {"docs": "counters: `ticks`\n"}),
    "r4_agreeing": ({"serving/types.py": TYPES_DYNAMIC}, {"docs": DOCS_BOTH}),
    "r4_phantom": ({"serving/types.py": TYPES_DYNAMIC},
                   {"docs": DOCS_BOTH, "check_bench": PHANTOM_CHECK_BENCH}),
    "r4_no_snapshot": ({"serving/types.py": TYPES_DYNAMIC.split("    def snapshot")[0]},
                       {"docs": DOCS_BOTH}),
    "r4_bad_report": ({"serving/types.py": TYPES_DYNAMIC},
                      {"docs": DOCS_BOTH, "check_bench": PHANTOM_CHECK_BENCH.replace(
                          "phantom_counter", "ticks") + "def check_report(r):\n    return []\n",
                       "bench_report": "{not json"}),
    "r6_missing": ({"kernels/ops.py": OPS_FIXTURE, "kernels/ref.py": REF_WITHOUT_ORACLES},
                   {"kernel_tests": "def test_other():\n    pass\n"}),
    "r6_registered": ({"kernels/ops.py": OPS_FIXTURE, "kernels/ref.py": REF_WITH_ORACLES},
                      {"kernel_tests": "def test_myop():\n    assert myop\n"}),
    "r6_unregistered_untested": ({"kernels/ops.py": OPS_FIXTURE,
                                  "kernels/ref.py": 'ORACLES = {"other": None}\n'},
                                 {"kernel_tests": "def test_other():\n    pass\n"}),
    "r7_inert": ({"core/config.py": CONFIG_FIXTURE, "core/user.py": R7_USER}, {}),
    "r7_string_kwarg": ({"core/config.py": CONFIG_FIXTURE, "core/user.py": R7_STRING_USER},
                        {}),
    "r7_analysis_not_a_consumer": ({"core/config.py": CONFIG_FIXTURE, "core/user.py": R7_USER,
                                    "analysis/user.py": "X = 'ghost_knob'\n"}, {}),
}


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_held_to_reference(tmp_path, name):
    assert_held_to_reference(tmp_path, {"fix.py": fixture(name)})


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_held_to_reference(tmp_path, name):
    pkg_files, anchors = TREES[name]
    assert_held_to_reference(tmp_path, pkg_files, anchors)


def test_bench_anchor_tree_held_to_reference(tmp_path):
    """R4 parts 3-4 on the reference's real bench files, with each
    package's real types.py in turn."""
    anchors = {k: repo_text(REF_ANCHORS[k])
               for k in ("docs", "check_bench", "bench_test", "bench_report")}
    for pkg in ("repro", "repro_torch"):
        types_src = repo_text(f"src/{pkg}/serving/types.py")
        ref, port = assert_held_to_reference(
            tmp_path / pkg, {"serving/types.py": types_src}, anchors)
        assert port.ok, port.render()


def _relocate(tmp_path, src_pkg, dst_pkg, anchors_from, anchors_to):
    """Copy ``src/<src_pkg>/`` to ``tmp/src/<dst_pkg>/``, with the anchor
    files that exist at ``anchors_from`` paths written at ``anchors_to``'s."""
    shutil.copytree(os.path.join(REPO_ROOT, "src", src_pkg),
                    tmp_path / "src" / dst_pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for role, rel in anchors_from.items():
        if os.path.exists(os.path.join(REPO_ROOT, rel)):
            write_tree(tmp_path, {anchors_to[role]: repo_text(rel)})
    return str(tmp_path / "empty.json")


def test_reference_tree_relocated_held_to_reference(tmp_path):
    """The reference's src/repro/ under src/repro_torch/: the port's
    linter finds what the reference's finds on its own tree."""
    empty = _relocate(tmp_path, "repro", "repro_torch", REF_ANCHORS, PORT_ANCHORS)
    ref = reference_run_analysis(REPO_ROOT, baseline_path=empty)
    port = run_analysis(str(tmp_path), baseline_path=empty)
    assert normalized(port, port=True) == normalized(ref, port=False), (
        f"reference:\n{ref.render()}\nport:\n{port.render()}")
    assert (len(port.findings), len(port.suppressed)) == (4, 4)


def test_port_tree_relocated_held_to_reference(tmp_path):
    """The port's src/repro_torch/ under src/repro/: the reference's
    linter finds what the port's finds on the port's own tree."""
    empty = _relocate(tmp_path, "repro_torch", "repro", PORT_ANCHORS, REF_ANCHORS)
    ref = reference_run_analysis(str(tmp_path), baseline_path=empty)
    port = run_analysis(REPO_ROOT, baseline_path=empty)
    assert normalized(port, port=True) == normalized(ref, port=False), (
        f"reference:\n{ref.render()}\nport:\n{port.render()}")
    assert (len(port.findings), len(port.suppressed)) == (4, 4)


def test_cli_runs_as_a_module():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")},
    )
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.strip().endswith("0 finding(s), 4 pragma-suppressed, 4 baselined")
