"""replint-torch engine: file discovery, suppressions, rule dispatch, reporting.

Counterpart of ``repro.lint.engine``.  Usage (CLI in
``repro_torch.lint.__main__``)::

    PYTHONPATH=src python -m repro_torch.lint

Suppression syntax (comment on the offending line, or on a line of its own
directly above it)::

    x = int(tok)   # replint-torch: disable=TRC101 -- host sync on purpose: <why>
    # replint-torch: disable=TRC101,TRC103 -- debugging block, never captured
    # replint-torch: disable=ALL -- generated file

A reason string after ``--`` is mandatory; a reasonless suppression is
itself a finding (REP001), and a suppression that matches nothing is too
(REP002).  ``# replint-torch: traced -- why`` on a ``def`` line (or the line
above) marks a function as a cross-module trace root for the call graph.

The marker is ``replint-torch:``, not the JAX package's ``replint:``: the
JAX linter reads ``# replint:`` comments in every file it lints, and none of
its trace rules reaches ``src/repro_torch/``, so it would report each such
suppression in the port as unused (its REP002).  Neither tool's regex
matches the other's marker.
"""
from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

from .callgraph import ModuleGraph, build_graph, build_imports

TOOL = "replint-torch"

_SUPPRESS_RE = re.compile(
    r"#\s*replint-torch:\s*disable\s*=\s*(?P<rules>[\w,\s-]+?)"
    r"(?:\s*--\s*(?P<reason>.*\S))?\s*$")
_TRACED_RE = re.compile(r"#\s*replint-torch:\s*traced\b")

#: directory names never linted unless explicitly requested
EXCLUDED_DIRS = {"lint_fixtures", "__pycache__", ".git", "artifacts"}


@dataclass
class Finding:
    rule: str            # e.g. "TRC101"
    name: str            # e.g. "host-sync"
    path: str            # repo-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str | None = None

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_json(self) -> dict:
        out = {"rule": self.rule, "name": self.name, "path": self.path,
               "line": self.line, "col": self.col, "message": self.message}
        if self.suppressed:
            out["suppressed"] = True
            out["reason"] = self.reason
        return out


@dataclass
class Suppression:
    line: int                 # line the comment sits on
    rules: tuple[str, ...]    # rule ids/names, or ("ALL",)
    reason: str | None
    own_line: bool            # comment-only line (applies to the next line)
    used: bool = False

    def covers(self, finding_line: int) -> bool:
        if finding_line == self.line:
            return True
        return self.own_line and finding_line == self.line + 1

    def matches(self, rule_id: str, rule_name: str) -> bool:
        return ("ALL" in self.rules or rule_id in self.rules
                or rule_name in self.rules)


@dataclass
class ModuleContext:
    """Everything a rule needs about one file."""
    path: str                          # repo-relative posix
    tree: ast.Module
    source: str
    imports: dict[str, str]
    graph: ModuleGraph
    suppressions: list[Suppression]
    traced_lines: frozenset[int]


def parse_comments(source: str) -> tuple[list[Suppression], frozenset[int]]:
    suppressions: list[Suppression] = []
    traced: set[int] = set()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line_no, col = tok.start
            if _TRACED_RE.search(tok.string):
                traced.add(line_no)
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                rules = tuple(r.strip() for r in m.group("rules").split(",")
                              if r.strip())
                suppressions.append(Suppression(
                    line=line_no, rules=rules, reason=m.group("reason"),
                    own_line=(col == 0 or tok.line[:col].strip() == "")))
    except tokenize.TokenError:
        pass
    return suppressions, frozenset(traced)


def build_context(path: Path, rel: str) -> ModuleContext | None:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    suppressions, traced = parse_comments(source)
    imports = build_imports(tree)
    graph = build_graph(tree, imports, traced)
    return ModuleContext(path=rel, tree=tree, source=source, imports=imports,
                         graph=graph, suppressions=suppressions,
                         traced_lines=traced)


def discover(paths: list[str], root: Path, *,
             include_fixtures: bool = False) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        candidate = (root / p) if not Path(p).is_absolute() else Path(p)
        if candidate.is_file() and candidate.suffix == ".py":
            files.append(candidate)
        elif candidate.is_dir():
            for f in sorted(candidate.rglob("*.py")):
                parts = set(f.parts)
                if not include_fixtures and parts & EXCLUDED_DIRS:
                    continue
                files.append(f)
    seen: set[Path] = set()
    out = []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    n_files: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def to_json(self) -> dict:
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "tool": TOOL,
            "n_files": self.n_files,
            "n_findings": len(self.findings),
            "n_suppressed": len(self.suppressed),
            "counts": counts,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
        }

    def write_json(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=2) + "\n")


def run_rules(ctx: ModuleContext, rules, *, respect_scope: bool = True,
              with_meta: bool = True) -> tuple[list[Finding], list[Finding]]:
    """Run ``rules`` over one module; returns (active, suppressed)."""
    raw: list[Finding] = []
    for rule in rules:
        if respect_scope and not rule.applies(ctx.path):
            continue
        raw.extend(rule.check(ctx))

    active: list[Finding] = []
    suppressed: list[Finding] = []
    for f in raw:
        hit = None
        for s in ctx.suppressions:
            if s.covers(f.line) and s.matches(f.rule, f.name):
                hit = s
                break
        if hit is not None:
            hit.used = True
            f.suppressed = True
            f.reason = hit.reason
            suppressed.append(f)
        else:
            active.append(f)

    if with_meta:
        for s in ctx.suppressions:
            if s.reason is None:
                active.append(Finding(
                    rule="REP001", name="suppress-no-reason", path=ctx.path,
                    line=s.line, col=0,
                    message=("suppression without a reason; write "
                             "'# replint-torch: disable=%s -- <why>'"
                             % ",".join(s.rules))))
            if not s.used:
                active.append(Finding(
                    rule="REP002", name="unused-suppression", path=ctx.path,
                    line=s.line, col=0,
                    message=("suppression for %s matches no finding; "
                             "remove it" % ",".join(s.rules))))
    return active, suppressed


def lint_paths(paths: list[str], *, root: str | Path = ".",
               rules=None, respect_scope: bool = True,
               include_fixtures: bool = False,
               select: tuple[str, ...] | None = None) -> Report:
    from .rules import ALL_RULES
    root = Path(root).resolve()
    if rules is None:
        rules = ALL_RULES
    if select:
        wanted = set(select)
        rules = [r for r in rules if r.id in wanted or r.name in wanted]
    # meta findings (REP00x) only make sense on a full-rule run: a partial
    # run would report every unrelated suppression as "unused"
    with_meta = select is None

    report = Report()
    for f in discover(paths, root, include_fixtures=include_fixtures):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        ctx = build_context(f, rel)
        if ctx is None:
            report.findings.append(Finding(
                rule="REP000", name="parse-error", path=rel, line=1, col=0,
                message="file could not be parsed"))
            continue
        report.n_files += 1
        active, suppressed = run_rules(ctx, rules,
                                       respect_scope=respect_scope,
                                       with_meta=with_meta)
        report.findings.extend(active)
        report.suppressed.extend(suppressed)
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    report.suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report


__all__ = ["Finding", "Suppression", "ModuleContext", "Report", "TOOL",
           "build_context", "discover", "lint_paths", "run_rules",
           "parse_comments"]
