"""Control-plane invariant rules (CPL3xx).

Counterpart of ``repro.lint.rules.controlplane``, with the same verdicts:
the rules read only Python's AST, so nothing of them changes with the
framework.  The convergence planner, the scaling controller and the chaos
drills must be deterministic and replayable: every decision is a pure
function of (observation, config, seed) and the JSONL audit log replays
bit-exact.  These rules keep wall-clock reads, ambient RNG, unit confusion
and out-of-band state mutation out of the port's ``core/chaos/``,
``core/convergence/`` and ``core/scaling/``; CPL303 runs on every file.
"""
from __future__ import annotations

import ast

from ..callgraph import dotted_name
from ..engine import Finding, ModuleContext
from .base import CONTROL_PLANE_SCOPE, Rule

#: ambient-state calls banned from pure decision modules
_WALL_CLOCK = {
    "time.time", "time.monotonic", "time.perf_counter", "time.process_time",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow", "datetime.date.today",
    "datetime.now", "datetime.utcnow", "date.today",
}

#: module-level (unseeded, global-state) RNG entry points
_AMBIENT_RNG_MODULES = ("random.", "numpy.random.")
_AMBIENT_MISC = {"uuid.uuid4", "uuid.uuid1", "os.urandom", "secrets.token_hex",
                 "secrets.token_bytes", "secrets.randbelow"}

#: unit families inferred from name suffixes; arithmetic may not mix them
_UNIT_SUFFIXES = {
    "_s": "seconds", "_secs": "seconds", "_seconds": "seconds",
    "_ms": "milliseconds",
    "_steps": "steps", "_step": "steps",
    "_hours": "hours", "_unit_hours": "hours",
    "_bins": "bins",
}

class WallClockRule(Rule):
    id = "CPL301"
    name = "wall-clock"
    description = ("no time/random/datetime wall-clock or unseeded RNG in "
                   "core/convergence and core/scaling; decisions must be "
                   "pure functions of (observation, config, seed)")
    scope = CONTROL_PLANE_SCOPE

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func, ctx.imports)
            if name is None:
                continue
            if name in _WALL_CLOCK:
                findings.append(self.finding(
                    ctx, node,
                    f"{name}() reads the wall clock in a pure control-plane "
                    "module; take 'now' as a parameter so audit replay "
                    "stays bit-exact"))
            elif name in _AMBIENT_MISC:
                findings.append(self.finding(
                    ctx, node,
                    f"{name}() draws ambient entropy in a pure control-plane "
                    "module; derive ids/draws from the seeded rng"))
            elif name.startswith(_AMBIENT_RNG_MODULES):
                tail = name.split(".")[-1]
                if name.endswith(".default_rng") or tail in ("Generator",
                                                             "RandomState",
                                                             "Random",
                                                             "SeedSequence"):
                    # constructor: fine if and only if explicitly seeded
                    if not node.args and not node.keywords:
                        findings.append(self.finding(
                            ctx, node,
                            f"{name}() without a seed in a control-plane "
                            "module; pass an explicit seed for replayable "
                            "decisions"))
                else:
                    findings.append(self.finding(
                        ctx, node,
                        f"{name}() uses the global RNG in a control-plane "
                        "module; use a seeded np.random.default_rng(seed)"))
        return findings


class UnitMixRule(Rule):
    id = "CPL302"
    name = "unit-mix"
    description = ("additive arithmetic and comparisons may not mix names "
                   "with different unit suffixes (_s, _ms, _steps, "
                   "_unit_hours ...); multiply/divide to convert first")
    scope = CONTROL_PLANE_SCOPE

    def _unit_of(self, node: ast.expr) -> str | None:
        """Unit family of an expression, when inferable from a name."""
        if isinstance(node, ast.Name):
            return self._unit_of_name(node.id)
        if isinstance(node, ast.Attribute):
            return self._unit_of_name(node.attr)
        if isinstance(node, ast.UnaryOp):
            return self._unit_of(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                      (ast.Add, ast.Sub)):
            # additive chain keeps its operands' (single) unit
            left = self._unit_of(node.left)
            return left if left is not None else self._unit_of(node.right)
        return None   # literals, calls, mult/div results: unit-less here

    def _unit_of_name(self, name: str) -> str | None:
        for suffix in sorted(_UNIT_SUFFIXES, key=len, reverse=True):
            if name.endswith(suffix):
                return _UNIT_SUFFIXES[suffix]
        return None

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for node in ast.walk(ctx.tree):
            pairs: list[tuple[ast.expr, ast.expr]] = []
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          (ast.Add, ast.Sub)):
                pairs.append((node.left, node.right))
            elif isinstance(node, ast.Compare):
                operands = [node.left, *node.comparators]
                pairs.extend(zip(operands, operands[1:]))
            elif isinstance(node, ast.AugAssign) and isinstance(
                    node.op, (ast.Add, ast.Sub)):
                pairs.append((node.target, node.value))
            for left, right in pairs:
                lu, ru = self._unit_of(left), self._unit_of(right)
                if lu is not None and ru is not None and lu != ru:
                    findings.append(self.finding(
                        ctx, node,
                        f"'{ast.unparse(left)}' ({lu}) combined with "
                        f"'{ast.unparse(right)}' ({ru}) without a unit "
                        "conversion; multiply/divide by the rate first"))
        return findings


class PrivateMutationRule(Rule):
    id = "CPL303"
    name = "private-mutation"
    description = ("underscore attributes of another object may not be "
                   "assigned or mutated from outside its class; go through "
                   "the public API (keeps CapacityPlan/DesiredGroup state "
                   "consistent with the audit log)")

    _MUTATORS = {"append", "extend", "insert", "pop", "remove", "clear",
                 "update", "add", "discard", "popleft", "appendleft",
                 "setdefault", "popitem", "sort"}

    def _owner_ok(self, value: ast.expr) -> bool:
        """Mutating ``self._x`` / ``cls._x`` (and their subscripts) is the
        class's own business; anything else is an outside write."""
        while isinstance(value, ast.Subscript):
            value = value.value
        return isinstance(value, ast.Name) and value.id in ("self", "cls")

    def _private_attr(self, node: ast.expr) -> ast.Attribute | None:
        """The ``<obj>._priv`` attribute access at the base of a target."""
        while isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute) and node.attr.startswith("_")
                and not node.attr.startswith("__")):
            return node
        return None

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for node in ast.walk(ctx.tree):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = list(node.targets)
            elif isinstance(node, ast.Call) and isinstance(node.func,
                                                           ast.Attribute):
                if node.func.attr in self._MUTATORS:
                    attr = self._private_attr(node.func.value)
                    if attr is not None and not self._owner_ok(attr.value):
                        findings.append(self.finding(
                            ctx, node,
                            f"'.{node.func.attr}()' mutates private "
                            f"attribute '{ast.unparse(attr)}' from outside "
                            "its class; use the owning object's public API"))
                continue
            for t in targets:
                for base in self._target_bases(t):
                    attr = self._private_attr(base)
                    if attr is not None and not self._owner_ok(attr.value):
                        findings.append(self.finding(
                            ctx, node,
                            f"assignment to private attribute "
                            f"'{ast.unparse(attr)}' from outside its class; "
                            "use the owning object's public API"))
        return findings

    def _target_bases(self, t: ast.expr):
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                yield from self._target_bases(e)
        elif isinstance(t, ast.Starred):
            yield from self._target_bases(t.value)
        else:
            yield t


CONTROL_PLANE_RULES = [WallClockRule(), UnitMixRule(), PrivateMutationRule()]
