"""Trace-safety rules (TRC1xx) for PyTorch.

Counterpart of ``repro.lint.rules.trace``.  The three rules examine only
functions the call graph marks reachable (``torch.compile`` and CUDA-graph
roots, ``# replint-torch: traced`` entry points, and what they call) and
the bodies of ``with torch.cuda.graph(...)`` regions, and fire only where
the staticness classifier is *sure* the operand is a device tensor --
UNKNOWN stays silent by design: a gate that cries wolf gets suppressed
wholesale and protects nothing.

Each finding is a point where the host waits for the card: on an eager
step it stalls the host's enqueue behind the device, and inside a CUDA-graph
capture it fails the capture.
"""
from __future__ import annotations

import ast

from ..callgraph import dotted_name
from ..engine import Finding, ModuleContext
from ..staticness import (TENSOR, Env, EnvBuilder, classify,
                          function_statements, is_display, is_host_target,
                          param_env, walk_expressions)
from .base import TRACE_SCOPE, Rule

#: ``x.<attr>()`` methods of a tensor that copy it to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__bool__", "__float__",
                 "__int__"}

#: dotted calls that wait for the device whatever their operands (and any
#: ``.synchronize()`` method: a stream's or an event's)
_SYNC_CALLS = {"torch.cuda.synchronize"}

#: dotted host-library calls that materialize their tensor argument
_HOST_CALLS = {"numpy.asarray", "numpy.array", "numpy.copy",
               "numpy.asanyarray", "numpy.ascontiguousarray"}

#: builtins that coerce a tensor to a host scalar
_COERCIONS = {"int", "float", "bool", "complex"}

#: builtins/functions that stringify their arguments (TRC103)
_FORMATTERS = {"print", "str", "repr", "format"}


def _iter_traced_functions(ctx: ModuleContext):
    """Yield (owner, name, env, region) for each reachable function, with
    the environment seeded from params + enclosing scopes; ``region`` is
    None (check every statement) or a capture region's ``with`` node (check
    only the statements inside it, in a function that is not itself
    reachable, or at module level: the owner is then the module)."""
    envs: dict[int, Env] = {}

    def env_for(info) -> Env:
        key = id(info.node)
        if key not in envs:
            parent = env_for(info.parent) if info.parent is not None else None
            envs[key] = param_env(info, parent)
        return envs[key]

    for info in ctx.graph.jit_reachable_functions():
        yield info.node, info.qualname, env_for(info), None
    for with_node, scope in ctx.graph.capture_regions:
        if scope is None:
            yield ctx.tree, "<module>", Env(), with_node
        elif not scope.jit_reachable:
            yield scope.node, scope.qualname, env_for(scope), with_node


def _inside(stmt: ast.stmt, region: ast.AST) -> bool:
    return any(sub is stmt for body_stmt in region.body
               for sub in ast.walk(body_stmt))


def _scan(ctx: ModuleContext, on_stmt) -> list[Finding]:
    """Drive a statement-order walk over every traced function and capture
    region; ``on_stmt`` gets (qualname, stmt, env) and returns findings for
    that statement."""
    out: list[Finding] = []
    for owner, name, env, region in _iter_traced_functions(ctx):
        builder = EnvBuilder(env, ctx.imports)
        if isinstance(owner, ast.Lambda):
            out.extend(on_stmt(name, ast.Expr(value=owner.body), env))
            continue
        for stmt in function_statements(owner):
            if region is None or _inside(stmt, region):
                out.extend(on_stmt(name, stmt, env))
            builder.visit_stmt(stmt)
    return out


class HostSyncRule(Rule):
    id = "TRC101"
    name = "host-sync"
    description = (".item()/.tolist()/.cpu()/.numpy()/.to('cpu'), int()/"
                   "float()/bool() or np.asarray of a tensor, and stream/"
                   "event/device synchronize() inside hot-path functions")
    scope = TRACE_SCOPE

    def check(self, ctx: ModuleContext) -> list[Finding]:
        def on_stmt(where, stmt, env):
            findings = []
            for node in walk_expressions(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func, ctx.imports)
                tensor_arg = any(classify(a, env, ctx.imports) == TENSOR
                                 for a in node.args)
                if name in _SYNC_CALLS or (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "synchronize"):
                    findings.append(self.finding(
                        ctx, node,
                        f"{ast.unparse(node.func)}() in '{where}' blocks the "
                        "host until the card is idle (and fails a CUDA-graph "
                        "capture)"))
                elif name in _HOST_CALLS and tensor_arg:
                    findings.append(self.finding(
                        ctx, node,
                        f"{name.split('.')[-1]}() of a tensor in '{where}' "
                        "copies it to the host and waits for the card"))
                elif name in _COERCIONS and tensor_arg:
                    findings.append(self.finding(
                        ctx, node,
                        f"{name}() of a tensor in '{where}' waits for the "
                        "card (keep it a tensor: torch.where / masks)"))
                elif (isinstance(node.func, ast.Attribute)
                      and classify(node.func.value, env, ctx.imports) == TENSOR
                      and (node.func.attr in _SYNC_METHODS
                           or (node.func.attr == "to"
                               and is_host_target(node)))):
                    findings.append(self.finding(
                        ctx, node,
                        f".{node.func.attr}() of a tensor in '{where}' copies "
                        "it to the host and waits for the card"))
            return findings
        return _scan(ctx, on_stmt)


class TensorBranchRule(Rule):
    id = "TRC102"
    name = "tensor-branch"
    description = ("no Python if/while/for/assert or conditional expression "
                   "on a tensor inside hot-path functions: each is an implicit "
                   "bool() sync (use torch.where / masks)")
    scope = TRACE_SCOPE

    def check(self, ctx: ModuleContext) -> list[Finding]:
        def on_stmt(where, stmt, env):
            findings = []
            tests: list[tuple[ast.AST, str]] = []
            if isinstance(stmt, (ast.If, ast.While)):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                tests.append((stmt.test, kind))
            elif isinstance(stmt, ast.Assert):
                tests.append((stmt.test, "assert"))
            elif isinstance(stmt, ast.For):
                tests.append((stmt.iter, "for"))
            for node in walk_expressions(stmt):
                if isinstance(node, ast.IfExp):
                    tests.append((node.test, "conditional expression"))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    for gen in node.generators:
                        tests.append((gen.iter, "comprehension"))
            for test, kind in tests:
                if is_display(test, env):
                    continue    # a host container of tensors: no read
                if classify(test, env, ctx.imports) == TENSOR:
                    findings.append(self.finding(
                        ctx, test,
                        f"Python {kind} on a tensor in '{where}' reads it on "
                        "the host (an implicit bool() sync) -- use "
                        "torch.where / a mask"))
            return findings
        return _scan(ctx, on_stmt)


class TensorFormatRule(Rule):
    id = "TRC103"
    name = "tensor-format"
    description = ("no f-strings/print/str()/repr()/format() of tensors "
                   "inside hot-path functions (each copies the values to the "
                   "host)")
    scope = TRACE_SCOPE

    def check(self, ctx: ModuleContext) -> list[Finding]:
        def on_stmt(where, stmt, env):
            findings = []
            for node in walk_expressions(stmt):
                if isinstance(node, ast.FormattedValue):
                    if classify(node.value, env, ctx.imports) == TENSOR:
                        findings.append(self.finding(
                            ctx, node,
                            f"f-string formats a tensor in '{where}' (copies "
                            "its values to the host)"))
                elif isinstance(node, ast.Call):
                    name = dotted_name(node.func, ctx.imports)
                    if name in _FORMATTERS and any(
                            classify(a, env, ctx.imports) == TENSOR
                            for a in node.args):
                        findings.append(self.finding(
                            ctx, node,
                            f"{name}() of a tensor in '{where}' (copies its "
                            "values to the host)"))
            return findings
        return _scan(ctx, on_stmt)


TRACE_RULES = [HostSyncRule(), TensorBranchRule(), TensorFormatRule()]
