"""CLI entry point: ``python -m repro_torch.lint [paths ...]``.

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""
from __future__ import annotations

import argparse
import sys

from .engine import lint_paths
from .rules import ALL_RULES, META_RULES
from .selftest import run_selftest

DEFAULT_PATHS = ["src/repro_torch", "tests", "chip_smoke.py", "tools"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="replint-torch: trace-safety, kernel-launch and "
                    "control-plane rules for the PyTorch port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--json", metavar="FILE",
                    help="write the JSON report to FILE")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE",
                    help="run only these rule ids/names (repeatable; "
                         "disables REP00x meta checks)")
    ap.add_argument("--no-scope", action="store_true",
                    help="ignore per-rule path scopes (lint everything "
                         "with every rule)")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also lint tests/lint_fixtures (excluded by "
                         "default; the corpus is full of violations on "
                         "purpose)")
    ap.add_argument("--selftest", action="store_true",
                    help="verify every rule fires on its fixture corpus "
                         "entry and stays silent on the clean twin")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--root", default=".",
                    help="repo root for relative paths (default: cwd)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-finding lines; print the summary "
                         "only")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            scope = ", ".join(rule.scope) if rule.scope else "all files"
            print(f"{rule.id}  {rule.name:20s} [{scope}]")
            print(f"        {rule.description}")
        for rid, name, desc in META_RULES:
            print(f"{rid}  {name:20s} [engine]")
            print(f"        {desc}")
        return 0

    if args.selftest:
        return run_selftest(args.root, verbose=not args.quiet)

    paths = args.paths or DEFAULT_PATHS
    report = lint_paths(paths, root=args.root,
                        respect_scope=not args.no_scope,
                        include_fixtures=args.include_fixtures,
                        select=tuple(args.select) if args.select else None)

    if args.json:
        report.write_json(args.json)

    if not args.quiet:
        for f in report.findings:
            print(f"{f.location()} {f.rule} {f.name}: {f.message}")
    n = len(report.findings)
    print(f"replint-torch: {report.n_files} files, {n} finding"
          f"{'' if n == 1 else 's'}, {len(report.suppressed)} suppressed")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
