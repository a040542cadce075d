"""Fixture-corpus selftest: every rule fires on its ``*_fire.py`` fixture
and stays silent on the ``*_clean.py`` twin.

Counterpart of ``repro.lint.selftest``; a pytest target
(tests/test_torch_lint.py) and a CLI mode (``python -m repro_torch.lint
--selftest``).  The corpus lives in ``tests/lint_fixtures/torch/``: the path
component ``lint_fixtures`` keeps it out of both linters' default discovery.
"""
from __future__ import annotations

from pathlib import Path

from .engine import lint_paths
from .rules import ALL_RULES

FIXTURE_DIR = "tests/lint_fixtures/torch"

#: engine-emitted meta rules also have fixture pairs
SELFTEST_IDS = [r.id for r in ALL_RULES] + ["REP001", "REP002"]


def fixture_pair(rule_id: str, root: str | Path = ".") -> tuple[Path, Path]:
    base = Path(root) / FIXTURE_DIR
    return (base / f"{rule_id.lower()}_fire.py",
            base / f"{rule_id.lower()}_clean.py")


def check_rule(rule_id: str, root: str | Path = ".") -> list[str]:
    """Return a list of problems (empty == the rule's corpus is healthy)."""
    fire, clean = fixture_pair(rule_id, root)
    problems: list[str] = []
    if not fire.exists() or not clean.exists():
        return [f"{rule_id}: fixture pair missing under {FIXTURE_DIR}/"]

    fire_report = lint_paths([str(fire)], root=root, respect_scope=False,
                             include_fixtures=True)
    clean_report = lint_paths([str(clean)], root=root, respect_scope=False,
                              include_fixtures=True)

    if not any(f.rule == rule_id for f in fire_report.findings):
        problems.append(
            f"{rule_id}: did not fire on {fire.name} "
            f"(got: {[f.rule for f in fire_report.findings] or 'nothing'})")
    if any(f.rule == rule_id for f in clean_report.findings):
        lines = [str(f.line) for f in clean_report.findings
                 if f.rule == rule_id]
        problems.append(
            f"{rule_id}: fired on clean twin {clean.name} "
            f"(lines {', '.join(lines)})")
    return problems


def run_selftest(root: str | Path = ".", *, verbose: bool = True) -> int:
    failures = 0
    for rule_id in SELFTEST_IDS:
        problems = check_rule(rule_id, root)
        if problems:
            failures += 1
            for p in problems:
                print(f"FAIL {p}")
        elif verbose:
            print(f"ok   {rule_id}")
    if failures:
        print(f"selftest: {failures}/{len(SELFTEST_IDS)} rules unhealthy")
    elif verbose:
        print(f"selftest: all {len(SELFTEST_IDS)} rules fire on their "
              "fixtures and stay silent on the clean twins")
    return 1 if failures else 0


__all__ = ["SELFTEST_IDS", "FIXTURE_DIR", "fixture_pair", "check_rule",
           "run_selftest"]
