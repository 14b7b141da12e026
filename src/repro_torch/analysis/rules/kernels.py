"""R6 — kernel-oracle parity.

Motivating gap: ``paged_verify`` shipped as a public kernel entry
point with no dedicated parity test — it happened to delegate to
``paged_attention`` so nothing caught the hole, but a later rewrite of
the delegation would have gone untested. Accelerated kernels are only
trustworthy against a plain-``torch`` oracle.

For every public function in ``src/repro_torch/kernels/ops.py`` (no leading
underscore, defined at module level) the rule requires:

1. a registered oracle: an entry in ``kernels/ref.py``'s ``ORACLES``
   dict mapping the op name to its reference implementation;
2. a parity test: the op name appears in ``tests/test_torch_kernels.py``
   (any reference — the test imports and calls it); the reference's R6
   reads ``tests/test_kernels.py`` instead.
"""

from __future__ import annotations

import ast
import os

from repro_torch.analysis.engine import Finding
from repro_torch.analysis.rules.common import Rule

OPS_PATH = "src/repro_torch/kernels/ops.py"
REF_PATH = "src/repro_torch/kernels/ref.py"
TESTS_PATH = os.path.join("tests", "test_torch_kernels.py")


def _public_functions(module):
    for stmt in module.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not stmt.name.startswith("_"):
                yield stmt


def _oracle_keys(module):
    """String keys of the module-level ``ORACLES = {...}`` dict."""
    for stmt in module.tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        else:
            continue
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        if "ORACLES" not in names:
            continue
        if isinstance(stmt.value, ast.Dict):
            return {
                k.value for k in stmt.value.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            }
    return None


class KernelOracleRule(Rule):
    rule_id = "R6"
    title = ("every public kernels/ops.py entry point needs an ORACLES "
             "registry entry in kernels/ref.py and a parity test")

    def check_project(self, project):
        ops_mod = project.module(OPS_PATH)
        if ops_mod is None:
            return
        ref_mod = project.module(REF_PATH)
        oracle_keys = _oracle_keys(ref_mod) if ref_mod is not None else None
        if ref_mod is not None and oracle_keys is None:
            yield Finding(
                rule="R6", path=REF_PATH, line=1,
                message=("kernels/ref.py has no module-level ORACLES dict — "
                         "the op-name -> reference-fn registry R6 checks "
                         "against"),
                scope="", anchor="ORACLES",
            )
            oracle_keys = set()
        tests_src = project.read_text(TESTS_PATH.replace(os.sep, "/"))
        for fn in _public_functions(ops_mod):
            if oracle_keys is not None and fn.name not in oracle_keys:
                yield ops_mod.finding(
                    "R6", fn,
                    f"kernel entry point {fn.name}() has no ORACLES entry in "
                    "kernels/ref.py — register its plain-torch reference "
                    "implementation",
                )
            if tests_src is not None and fn.name not in tests_src:
                yield ops_mod.finding(
                    "R6", fn,
                    f"kernel entry point {fn.name}() is never referenced in "
                    "tests/test_torch_kernels.py — add a parity test against "
                    "its oracle",
                )
