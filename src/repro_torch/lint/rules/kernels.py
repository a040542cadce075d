"""Kernel-launch rules (KRN2xx), the port's counterpart of PLK201-204.

The JAX package's Pallas rules anchor on ``pl.pallas_call``; the port's
kernels are CUDA C++ behind a plain C interface, launched through ctypes,
so these rules anchor on the *launch site*: a call with at least one
``<tensor>.data_ptr()`` argument (every wrapper in ``kernels/*/ops.py``
launches this way).  A file with no launch site produces no work, so the
rules need no path scope.

* KRN201 grad-unguarded: the function that launches calls ``refuse_grad``
  on its inputs first (no kernel has a backward; an input that requires
  grad would get none, silently).
* KRN202 pointer-alias: the same tensor's ``data_ptr()`` twice in one
  launch (aliased input and output buffers race), PLK203's counterpart.
* KRN203 launch-off-stream: the stream argument comes from
  ``torch.cuda.current_stream(...)``: a literal ``0`` or ``None`` lands on
  the legacy stream, which a CUDA-graph capture refuses and which
  serializes against every other stream.
* KRN204 silent-fallback: an ``except`` around a launch that neither
  re-raises nor raises anything (a fallback that hides the kernel).
"""
from __future__ import annotations

import ast

from ..callgraph import dotted_name
from ..engine import Finding, ModuleContext
from .base import Rule

CURRENT_STREAM = "torch.cuda.current_stream"

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_local(node: ast.AST):
    """``ast.walk`` that does not enter nested function definitions."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if not isinstance(child, _FUNC_NODES + (ast.ClassDef,)):
                stack.append(child)


def pointer_bases(arg: ast.expr) -> list[ast.expr]:
    """The tensors whose ``data_ptr()`` an argument passes: ``x.data_ptr()``,
    either branch of a conditional expression, or the element of a starred
    generator (``*(t.data_ptr() for t in ...)``)."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr == "data_ptr" and not arg.args:
        return [arg.func.value]
    if isinstance(arg, ast.IfExp):
        return pointer_bases(arg.body) + pointer_bases(arg.orelse)
    if isinstance(arg, ast.Starred):
        inner = arg.value
        if isinstance(inner, (ast.GeneratorExp, ast.ListComp)):
            return pointer_bases(inner.elt)
        return pointer_bases(inner)
    return []


def _call_operands(call: ast.Call) -> list[ast.expr]:
    return list(call.args) + [k.value for k in call.keywords]


def launch_sites(tree: ast.Module):
    """Yield (call, enclosing function node or None) for every launch."""
    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            child_scope = child if isinstance(child, _FUNC_NODES) else scope
            if isinstance(child, ast.Call) and any(
                    pointer_bases(a) for a in _call_operands(child)):
                yield child, scope
            yield from visit(child, child_scope)
    yield from visit(tree, None)


def _enclosing_chain(tree: ast.Module, target: ast.AST) -> list[ast.AST]:
    """Function nodes enclosing ``target``, innermost first."""
    chain: list[ast.AST] = []

    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if child is target:
                chain.extend(reversed(stack))
                return True
            if visit(child, stack + [child] if isinstance(child, _FUNC_NODES)
                     else stack):
                return True
        return False

    visit(tree, [])
    return chain


def _params(fn: ast.AST) -> set[str]:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    return names


class GradUnguardedRule(Rule):
    id = "KRN201"
    name = "grad-unguarded"
    description = ("a function that launches a CUDA kernel calls refuse_grad "
                   "on its input tensors before the launch (no kernel has a "
                   "backward)")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for call, scope in launch_sites(ctx.tree):
            if scope is None:
                findings.append(self.finding(
                    ctx, call, "kernel launch at module level, with no "
                    "refuse_grad guard"))
                continue
            guards = [node for fn in _enclosing_chain(ctx.tree, call)
                      for node in _walk_local(fn)
                      if isinstance(node, ast.Call)
                      and (dotted_name(node.func, ctx.imports) or "").split(
                          ".")[-1] == "refuse_grad"
                      and node.lineno <= call.lineno]
            if not guards:
                findings.append(self.finding(
                    ctx, call, "kernel launch without a refuse_grad(...) call "
                    "before it: an input that requires grad would get none"))
                continue
            guarded = {a.id for g in guards for a in g.args
                       if isinstance(a, ast.Name)}
            params = _params(scope)
            missed = sorted({b.id for a in _call_operands(call)
                             for b in pointer_bases(a)
                             if isinstance(b, ast.Name) and b.id in params
                             and b.id not in guarded})
            if missed:
                findings.append(self.finding(
                    ctx, call, f"kernel launch reads input(s) {', '.join(missed)} "
                    "that no refuse_grad(...) call before it checks"))
        return findings


class PointerAliasRule(Rule):
    id = "KRN202"
    name = "pointer-alias"
    description = ("the same tensor's data_ptr() must not be passed twice to "
                   "one kernel launch (aliased input/output buffers race)")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for call, _scope in launch_sites(ctx.tree):
            seen: set[str] = set()
            for arg in _call_operands(call):
                for base in pointer_bases(arg):
                    key = ast.dump(base)
                    if key in seen:
                        findings.append(self.finding(
                            ctx, arg,
                            f"'{ast.unparse(base)}.data_ptr()' passed twice to "
                            "one launch; aliased buffers make the kernel's "
                            "writes order-dependent"))
                    seen.add(key)
        return findings


class LaunchOffStreamRule(Rule):
    id = "KRN203"
    name = "launch-off-stream"
    description = ("a kernel launch takes its stream from "
                   "torch.cuda.current_stream(...): 0 or None is the legacy "
                   "stream, which CUDA-graph capture refuses")

    def _is_current(self, expr: ast.expr, bound: dict[str, ast.expr],
                    imports, depth: int = 0) -> bool:
        if depth > 4:
            return False
        if isinstance(expr, ast.Attribute) and expr.attr == "cuda_stream":
            expr = expr.value
        if isinstance(expr, ast.Call):
            return dotted_name(expr.func, imports) == CURRENT_STREAM
        if isinstance(expr, ast.Name) and expr.id in bound:
            return self._is_current(bound[expr.id], bound, imports, depth + 1)
        return False

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        for call, _scope in launch_sites(ctx.tree):
            bound: dict[str, ast.expr] = {}
            for fn in reversed(_enclosing_chain(ctx.tree, call)):
                for node in _walk_local(fn):
                    if (isinstance(node, ast.Assign) and len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Name)):
                        bound[node.targets[0].id] = node.value
            if not any(self._is_current(a, bound, ctx.imports)
                       for a in _call_operands(call)):
                findings.append(self.finding(
                    ctx, call, "kernel launch with no stream argument from "
                    "torch.cuda.current_stream(...).cuda_stream (0 / None "
                    "is the legacy stream)"))
        return findings


class SilentFallbackRule(Rule):
    id = "KRN204"
    name = "silent-fallback"
    description = ("an except around a kernel launch must raise: a handler "
                   "that swallows the error hides the kernel behind a "
                   "fallback")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings = []
        launches = {id(call) for call, _ in launch_sites(ctx.tree)}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            if not any(id(sub) in launches for stmt in node.body
                       for sub in _walk_local(stmt)):
                continue
            for handler in node.handlers:
                if not any(isinstance(sub, ast.Raise) for stmt in handler.body
                           for sub in _walk_local(stmt)):
                    findings.append(self.finding(
                        ctx, handler, "except around a kernel launch neither "
                        "re-raises nor raises: a launch failure falls back "
                        "silently"))
        return findings


KERNEL_RULES = [GradUnguardedRule(), PointerAliasRule(), LaunchOffStreamRule(),
                SilentFallbackRule()]
