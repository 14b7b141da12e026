"""dslint CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Exit status 0 when clean (pragma-suppressed and justified-baseline
findings do not fail the run), 1 on findings/errors/stale baseline.

Options:

    paths...            lint only these repo-relative files (module rules);
                        project rules still run against the full tree
    --changed           lint only files differing from HEAD (fast mode)
    --root DIR          repo root (default: auto-detected from this file)
    --baseline PATH     baseline file (default: the committed one)
    --update-baseline   re-baseline current findings; requires --justify
    --justify TEXT      written justification recorded in each new entry
    --list-rules        print the rule catalog and exit
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.engine import changed_files, run_analysis, update_baseline
from repro_torch.analysis.rules import ALL_RULES


def _default_root() -> str:
    # src/repro_torch/analysis/__main__.py -> repo root is three levels up from
    # the package, then above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="dslint: AST invariant linter for the repro_torch port",
    )
    parser.add_argument("paths", nargs="*", help="repo-relative files to lint")
    parser.add_argument("--changed", action="store_true",
                        help="lint only files differing from HEAD")
    parser.add_argument("--root", default=_default_root())
    parser.add_argument("--baseline", default=None)
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--justify", default="")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id}  {rule.title}")
        return 0

    if args.update_baseline:
        try:
            update_baseline(
                args.root, justification=args.justify,
                baseline_path=args.baseline,
            )
        except ValueError as e:
            print(f"dslint: {e}", file=sys.stderr)
            return 2
        print("dslint: baseline updated")
        return 0

    paths = list(args.paths)
    if args.changed:
        paths += changed_files(args.root)
        if not paths:
            print("dslint: no changed files under src/repro_torch/ — nothing to lint")
            return 0
    report = run_analysis(
        args.root, paths=paths or None, baseline_path=args.baseline
    )
    print(report.render())
    return 0 if (report.ok and not report.stale_baseline) else 1


if __name__ == "__main__":
    raise SystemExit(main())
