"""Per-module call graph with trace-reachability, for PyTorch code.

Counterpart of ``repro.lint.callgraph``.  The trace-safety rules need to
know, for every function in a module, whether it runs on the *hot path*: a
step that is (or is meant to be) captured as a CUDA graph or compiled by
``torch.compile``.  Inside a capture a host sync fails the capture, and on
an eager hot path it stalls the host behind the device, so the trace rules
fire only on reachable functions.

The graph is *per module* (one file at a time): cross-module calls are not
resolved.  Functions that are hot-path entry points for *other* modules
(``repro_torch.models.lm.prefill``, called from the serving engine's step)
carry a ``# replint-torch: traced -- why`` comment on the ``def`` line or
the line above, which makes them roots here.

Root discovery:

* decorators: ``@torch.compile``, ``@torch.compile(...)`` and
  ``@functools.partial(torch.compile, ...)`` (``TRACE_WRAPPERS``);
* call sites: ``torch.compile(f)`` and
  ``torch.cuda.make_graphed_callables(f, ...)`` (or a tuple of callables)
  -- the function operands become roots;
* ``with torch.cuda.graph(...):`` bodies: every function referenced in the
  body becomes a root, and the body itself is a *capture region* the trace
  rules check with its enclosing function's names;
* ``# replint-torch: traced`` markers.

Propagation is the JAX package's: inside a reachable function, every
reference (call or bare name) that resolves to a module-level function, an
enclosing function's nested def, a ``self.``/``cls.`` method of the
enclosing class, a local alias (``g = f`` or ``g = functools.partial(f,
...)``), or a lambda literal marks that function reachable too.  Nested
defs of a reachable function are reachable.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: wrappers whose (first) functional argument runs on the captured path
TRACE_WRAPPERS = {"torch.compile", "torch.cuda.make_graphed_callables"}

#: context managers whose body is captured
CAPTURE_CONTEXTS = {"torch.cuda.graph"}

PARTIAL = {"functools.partial", "partial"}

FuncNode = ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda


@dataclass
class FunctionInfo:
    node: FuncNode
    name: str
    qualname: str
    parent: "FunctionInfo | None" = None   # enclosing function, if nested
    class_name: str | None = None          # owning class, if a method
    jit_reachable: bool = False            # on the traced (captured) path
    is_root: bool = False                  # explicitly rooted (not inherited)


@dataclass
class ModuleGraph:
    functions: dict[int, FunctionInfo] = field(default_factory=dict)
    module_funcs: dict[str, FunctionInfo] = field(default_factory=dict)
    classes: dict[str, dict[str, FunctionInfo]] = field(default_factory=dict)
    #: (``with`` node, enclosing FunctionInfo|None) of each capture region
    capture_regions: list[tuple] = field(default_factory=list)

    def info(self, node: FuncNode) -> FunctionInfo | None:
        return self.functions.get(id(node))

    def jit_reachable_functions(self) -> list[FunctionInfo]:
        return [f for f in self.functions.values() if f.jit_reachable]


def dotted_name(node: ast.expr, imports: dict[str, str]) -> str | None:
    """Canonical dotted name of an expression, resolving import aliases.

    ``F.softmax`` -> ``torch.nn.functional.softmax`` under ``import
    torch.nn.functional as F``.  Returns None for anything that is not a
    plain dotted chain.
    """
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = imports.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


def build_imports(tree: ast.Module) -> dict[str, str]:
    """Local name -> canonical dotted module/object path."""
    table: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                table[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                table[a.asname or a.name] = f"{node.module}.{a.name}"
    return table


class _Collector(ast.NodeVisitor):
    """First pass: record every function/lambda with its scope context."""

    def __init__(self, graph: ModuleGraph):
        self.graph = graph
        self.func_stack: list[FunctionInfo] = []
        self.class_stack: list[str] = []

    def _add(self, node: FuncNode, name: str) -> FunctionInfo:
        parent = self.func_stack[-1] if self.func_stack else None
        cls = self.class_stack[-1] if self.class_stack else None
        qual = ".".join(
            ([parent.qualname] if parent else [])
            + ([cls] if cls and not parent else []) + [name])
        info = FunctionInfo(node=node, name=name, qualname=qual,
                            parent=parent, class_name=cls)
        self.graph.functions[id(node)] = info
        if parent is None and not self.class_stack:
            self.graph.module_funcs[name] = info
        if self.class_stack and parent is None:
            self.graph.classes.setdefault(self.class_stack[-1], {})[name] = info
        return info

    def visit_ClassDef(self, node: ast.ClassDef):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node, name):
        info = self._add(node, name)
        self.func_stack.append(info)
        self.generic_visit(node)
        self.func_stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node, node.name)

    def visit_Lambda(self, node):
        self._visit_func(node, "<lambda>")


def _scope_chain(info: FunctionInfo | None) -> list[FunctionInfo]:
    out = []
    while info is not None:
        out.append(info)
        info = info.parent
    return out


class _Resolver:
    """Resolve a reference expression to a FunctionInfo, if possible."""

    def __init__(self, graph: ModuleGraph, imports: dict[str, str],
                 aliases: dict[int, dict[str, FunctionInfo]]):
        self.graph = graph
        self.imports = imports
        self.aliases = aliases  # per-function-id local name -> FunctionInfo

    def resolve(self, expr: ast.expr,
                scope: FunctionInfo | None) -> FunctionInfo | None:
        if isinstance(expr, ast.Lambda):
            return self.graph.info(expr)
        if isinstance(expr, ast.Call):
            fn = dotted_name(expr.func, self.imports)
            if fn in PARTIAL and expr.args:
                return self.resolve(expr.args[0], scope)
            if fn in TRACE_WRAPPERS and expr.args:
                return self.resolve(expr.args[0], scope)
            return None
        if isinstance(expr, ast.Name):
            for s in _scope_chain(scope):
                local = self.aliases.get(id(s.node), {})
                if expr.id in local:
                    return local[expr.id]
                # nested defs of an enclosing function
                for stmt in ast.walk(s.node):
                    if (isinstance(stmt, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                            and stmt.name == expr.id):
                        info = self.graph.info(stmt)
                        if info is not None and info.parent is s:
                            return info
            return self.graph.module_funcs.get(expr.id)
        if isinstance(expr, ast.Attribute):
            # self.method / cls.method within the enclosing class
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id in ("self", "cls")):
                for s in _scope_chain(scope):
                    if s.class_name:
                        meth = self.graph.classes.get(s.class_name, {})
                        if expr.attr in meth:
                            return meth[expr.attr]
        return None


def _collect_aliases(graph: ModuleGraph, imports: dict[str, str]
                     ) -> dict[int, dict[str, FunctionInfo]]:
    """``g = f`` and ``g = functools.partial(f, ...)`` bindings per scope."""
    aliases: dict[int, dict[str, FunctionInfo]] = {}
    resolver = _Resolver(graph, imports, aliases)

    def scan(body_owner: FuncNode, scope: FunctionInfo):
        for node in ast.walk(body_owner):
            if not isinstance(node, ast.Assign):
                continue
            if len(node.targets) != 1 or not isinstance(node.targets[0],
                                                        ast.Name):
                continue
            target = resolver.resolve(node.value, scope)
            if target is not None:
                aliases.setdefault(id(scope.node), {})[node.targets[0].id] = target

    # two passes so an alias of an alias still resolves
    for _ in range(2):
        for info in graph.functions.values():
            scan(info.node, info)
    return aliases


def _operands(expr: ast.expr) -> list[ast.expr]:
    """A wrapper's functional operand, or each element of a tuple/list of
    them (``make_graphed_callables((f, g), ...)``)."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        return list(expr.elts)
    return [expr]


def _is_wrapper(node: ast.expr, imports: dict[str, str]) -> bool:
    """``torch.compile`` / ``torch.compile(...)`` / ``partial(torch.compile,
    ...)`` as a decorator."""
    if dotted_name(node, imports) in TRACE_WRAPPERS:
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func, imports)
        if name in TRACE_WRAPPERS:
            return True
        if name in PARTIAL and node.args:
            return dotted_name(node.args[0], imports) in TRACE_WRAPPERS
    return False


def build_graph(tree: ast.Module, imports: dict[str, str],
                traced_lines: frozenset[int] = frozenset()) -> ModuleGraph:
    graph = ModuleGraph()
    _Collector(graph).visit(tree)
    aliases = _collect_aliases(graph, imports)
    resolver = _Resolver(graph, imports, aliases)

    # -- map every node to its enclosing function -------------------------------
    enclosing: dict[int, FunctionInfo | None] = {}

    def mark_scope(owner, scope):
        for child in ast.iter_child_nodes(owner):
            enclosing[id(child)] = scope
            child_scope = graph.info(child) if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.Lambda)) else scope
            mark_scope(child, child_scope)

    mark_scope(tree, None)

    roots: list[FunctionInfo] = []

    # -- decorator + marker roots ------------------------------------------------
    for info in graph.functions.values():
        node = info.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if (node.lineno in traced_lines
                    or (node.lineno - 1) in traced_lines):
                roots.append(info)
            if any(_is_wrapper(dec, imports) for dec in node.decorator_list):
                roots.append(info)

    # -- call-site roots and capture regions --------------------------------------
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func, imports)
            if fn in TRACE_WRAPPERS and node.args:
                scope = enclosing.get(id(node))
                for op in _operands(node.args[0]):
                    target = resolver.resolve(op, scope)
                    if target is not None:
                        roots.append(target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            if not any(isinstance(item.context_expr, ast.Call)
                       and dotted_name(item.context_expr.func, imports)
                       in CAPTURE_CONTEXTS for item in node.items):
                continue
            scope = enclosing.get(id(node))
            graph.capture_regions.append((node, scope))
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, (ast.Name, ast.Attribute, ast.Lambda)):
                        target = resolver.resolve(sub, scope)
                        if target is not None:
                            roots.append(target)

    # -- propagate ----------------------------------------------------------------
    def propagate(info: FunctionInfo):
        stack = [info]
        while stack:
            cur = stack.pop()
            if cur.jit_reachable:
                continue
            cur.jit_reachable = True
            for node in ast.walk(cur.node):
                nxt = None
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)) and node is not cur.node:
                    nxt = graph.info(node)
                    if nxt is not None and nxt.parent is not cur:
                        nxt = None          # handled by its own parent
                elif isinstance(node, (ast.Name, ast.Attribute)):
                    nxt = resolver.resolve(node, cur)
                if nxt is not None and not nxt.jit_reachable:
                    stack.append(nxt)

    for info in roots:
        info.is_root = True
        propagate(info)
    return graph


__all__ = ["FunctionInfo", "ModuleGraph", "build_graph", "build_imports",
           "dotted_name", "TRACE_WRAPPERS", "CAPTURE_CONTEXTS"]
