"""Three-level staticness classifier for expressions in hot-path functions.

Counterpart of ``repro.lint.staticness`` with PyTorch semantics.  Inside a
trace-reachable function the rules must tell host Python (shapes, config
flags, loop counters) from device tensors: ``int(x.shape[1])`` is free;
``int(logits)`` waits for the device.  Every expression classifies to one of
three levels:

* ``STATIC``  -- host Python, never a tensor (or a tensor already on the
  host: ``x.cpu()``, ``x.tolist()``, whose call is the sync);
* ``TENSOR``  -- known (or presumed) device tensor;
* ``UNKNOWN`` -- cannot tell; rules stay silent.

Rules fire only on ``TENSOR``.  The environment maps local names to levels
and is built per function:

* parameters default to TENSOR **except**: ``self``/``cls``; parameters
  whose annotation names a static Python type (``int``, ``float``, ``bool``,
  ``str``, a ``*Config`` class, ``Callable`` ...); ``**kwargs``;
* closure variables inherit the enclosing function's environment, module
  level is STATIC;
* assignments propagate: ``y = x + 1`` is as much a tensor as ``x``;
  ``n = x.shape[0]`` is STATIC whatever ``x`` is.

Always STATIC whatever their operands: the attributes ``.shape``,
``.dtype``, ``.ndim``, ``.device``, ``.is_cuda``, ``.requires_grad``; the
methods ``.size()``, ``.dim()``, ``.stride()``, ``.numel()``,
``.data_ptr()``, ``.element_size()``, ``.is_contiguous()``; the calls
``torch.cuda.*`` (streams, events, device queries), ``torch.device``,
``torch.Size``, ``len``, ``isinstance``; ``x is None`` tests; literals.

TENSOR factories: ``torch.<op>(...)`` and ``torch.nn.functional``,
``torch.linalg``, ``torch.fft``, ``torch.special`` calls other than the
metadata calls above, and any ``torch.Tensor`` method applied to a TENSOR.
A str subscript (``params["blocks"]``) or a dict method (``.items()``) of a
TENSOR-classified name is UNKNOWN: no tensor takes either, so the name is a
dict of tensors (a parameter pytree), not a tensor.
"""
from __future__ import annotations

import ast
import functools

from .callgraph import FunctionInfo, dotted_name

STATIC = 0
UNKNOWN = 1
TENSOR = 2

#: annotation names whose parameters are host Python values
_STATIC_ANNOTATIONS = {
    "int", "float", "bool", "str", "bytes", "tuple", "list", "dict", "set",
    "type", "object", "Callable", "callable", "Sequence", "Mapping",
    "Optional", "Any", "None",
}

#: attribute accesses that always yield host metadata
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "requires_grad",
                 "layout", "is_leaf", "itemsize"}

#: attribute accesses of a tensor that are tensors
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}

#: tensor methods that return host metadata
_STATIC_METHODS = {"size", "dim", "stride", "numel", "data_ptr", "element_size",
                   "is_contiguous", "nelement", "ndimension", "get_device",
                   "is_floating_point", "is_complex", "storage_offset",
                   "untyped_storage"}

#: tensor methods whose result lives on the host (the call itself is the
#: sync; TRC101 reports it)
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}

#: calls that always yield host values (metadata / type queries)
_STATIC_CALLS = {
    "len", "isinstance", "issubclass", "type", "id", "getattr", "hasattr",
    "range", "zip", "enumerate", "sorted", "min", "max", "abs", "round",
}

#: dotted torch calls that return host values even on tensors
_STATIC_DOTTED_CALLS = {
    "torch.device", "torch.Size", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled", "torch.numel",
    "torch.get_default_dtype", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.set_grad_enabled", "torch.Generator",
    "torch.manual_seed", "torch.get_default_device",
}

#: dotted prefixes of host-side torch namespaces (streams, events, devices)
_STATIC_PREFIXES = ("torch.cuda.", "torch.backends.")

#: namespaces whose calls produce tensors
_TENSOR_NAMESPACES = ("torch.nn.functional.", "torch.linalg.", "torch.fft.",
                      "torch.special.")


def _annotation_is_static(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):          # string annotation / None
        return (isinstance(ann.value, str)
                and _name_is_static(ann.value)) or ann.value is None
    if isinstance(ann, ast.Name):
        return _name_is_static(ann.id)
    if isinstance(ann, ast.Attribute):
        return _name_is_static(ann.attr)
    if isinstance(ann, ast.Subscript):          # Optional[int], list[int] ...
        return _annotation_is_static(ann.value)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        # PEP 604 unions: ``int | None`` parameters are config knobs
        return (_annotation_is_static(ann.left)
                or _annotation_is_static(ann.right))
    return False


def _name_is_static(name: str) -> bool:
    if name in _STATIC_ANNOTATIONS:
        return True
    # config/spec dataclasses are hyperparameter bags, never tensors
    return name.endswith(("Config", "Spec", "Settings", "Options"))


@functools.lru_cache(maxsize=None)
def tensor_methods() -> frozenset[str] | None:
    """The method names of ``torch.Tensor`` (None where torch is absent:
    every method of a TENSOR then counts as a tensor method)."""
    try:
        import torch
    except ImportError:          # pragma: no cover - the port needs torch
        return None
    return frozenset(n for n in dir(torch.Tensor) if not n.startswith("__"))


def _is_tensor_method(attr: str) -> bool:
    names = tensor_methods()
    return names is None or attr in names


def _is_tensor_factory(name: str) -> bool:
    if name in _STATIC_DOTTED_CALLS or name.startswith(_STATIC_PREFIXES):
        return False
    if name.startswith(_TENSOR_NAMESPACES):
        return True
    parts = name.split(".")
    return len(parts) == 2 and parts[0] == "torch" and parts[1][:1].islower()


class Env:
    """Chained name->level environment (function scope over closure scope)."""

    def __init__(self, parent: "Env | None" = None):
        self.parent = parent
        self.names: dict[str, int] = {}
        #: names bound to a tuple/list/set display: a host container of
        #: tensors, which ``for`` and ``if`` read without a sync
        self.containers: set[str] = set()

    def get(self, name: str) -> int:
        env: Env | None = self
        while env is not None:
            if name in env.names:
                return env.names[name]
            env = env.parent
        return STATIC   # module level: imports, constants, classes

    def set(self, name: str, level: int) -> None:
        self.names[name] = level
        self.containers.discard(name)

    def is_container(self, name: str) -> bool:
        env: Env | None = self
        while env is not None:
            if name in env.names:
                return name in env.containers
            env = env.parent
        return False


def is_display(node: ast.expr, env: Env) -> bool:
    """A tuple/list/set display, or a name bound to one: a host container,
    whose truth and iteration never read a tensor."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return True
    return isinstance(node, ast.Name) and env.is_container(node.id)


def param_env(info: FunctionInfo, parent: Env | None = None) -> Env:
    """Seed an environment from a function's parameter list."""
    env = Env(parent)
    args = info.node.args

    def classify_param(a: ast.arg) -> int:
        if a.arg in ("self", "cls"):
            return STATIC
        if getattr(a, "annotation", None) is not None:
            return STATIC if _annotation_is_static(a.annotation) else TENSOR
        return TENSOR

    for a in args.posonlyargs + args.args + args.kwonlyargs:
        env.set(a.arg, classify_param(a))
    if args.vararg:
        env.set(args.vararg.arg, classify_param(args.vararg))
    if args.kwarg:
        env.set(args.kwarg.arg, STATIC)   # the **kwargs dict itself is host-side
    return env


def classify(node: ast.expr, env: Env, imports: dict[str, str]) -> int:
    """Classify an expression as STATIC / UNKNOWN / TENSOR."""
    c = lambda n: classify(n, env, imports)   # noqa: E731

    if isinstance(node, ast.Constant):
        return STATIC
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return STATIC
        base = c(node.value)
        if base == STATIC:
            return STATIC      # cfg.n_heads, self.decode_steps, torch.float32 ...
        if base == TENSOR and node.attr in _TENSOR_ATTRS:
            return TENSOR
        return UNKNOWN         # an attribute of a tensor-ish object: murky
    if isinstance(node, ast.Subscript):
        base = c(node.value)
        if base == STATIC and isinstance(node.value, ast.Attribute) \
                and node.value.attr in _STATIC_ATTRS:
            return STATIC      # x.shape[0]
        if base == TENSOR and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            return UNKNOWN     # params["blocks"]: no tensor takes a str index
        return base
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return STATIC      # ``x is None`` never reads the device
        return max(c(node.left), *(c(cmp) for cmp in node.comparators))
    if isinstance(node, ast.BoolOp):
        return max(c(v) for v in node.values)
    if isinstance(node, ast.BinOp):
        return max(c(node.left), c(node.right))
    if isinstance(node, ast.UnaryOp):
        return c(node.operand)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        if not node.elts:
            return STATIC
        return max(c(e) for e in node.elts)
    if isinstance(node, ast.Dict):
        vals = [c(v) for v in node.values if v is not None]
        return max(vals) if vals else STATIC
    if isinstance(node, ast.IfExp):
        return max(c(node.body), c(node.orelse))
    if isinstance(node, ast.Starred):
        return c(node.value)
    if isinstance(node, ast.JoinedStr):
        return STATIC          # the *string* is host; TRC103 checks contents
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return UNKNOWN
    if isinstance(node, ast.Call):
        name = dotted_name(node.func, imports)
        if name in _STATIC_CALLS:
            return STATIC
        if name is not None:
            if name in ("int", "float", "bool", "str", "tuple", "list",
                        "dict", "complex"):
                return STATIC  # result is host Python (TRC101 flags the call)
            if name.startswith("torch."):
                return TENSOR if _is_tensor_factory(name) else STATIC
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _STATIC_METHODS or attr in _HOST_METHODS:
                return STATIC
            base = c(node.func.value)
            if attr in ("keys", "values", "items", "get", "copy"):
                # a container's view; no tensor has these methods, so a
                # TENSOR-classified base is a dict of them (a pytree)
                return UNKNOWN if base == TENSOR else base
            if base == TENSOR and _is_tensor_method(attr):
                if attr == "to" and is_host_target(node):
                    return STATIC
                return TENSOR
        return UNKNOWN
    return UNKNOWN


def is_host_target(call: ast.Call) -> bool:
    """Whether ``x.to(...)`` moves ``x`` to the host: a ``"cpu"`` literal
    (positional or ``device=``) or ``torch.device("cpu")``."""
    operands = list(call.args) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    for op in operands:
        if isinstance(op, ast.Call) and op.args:
            op = op.args[0]            # torch.device("cpu")
        if isinstance(op, ast.Constant) and isinstance(op.value, str) \
                and op.value.split(":")[0] == "cpu":
            return True
    return False


class EnvBuilder:
    """Walk a function's own statements in order, updating the environment.

    Callers hand ``visit_stmt`` each statement *after* running their checks
    on it, so name levels reflect program order.  Nested function
    definitions are skipped -- they are separate graph nodes and get their
    own environment (seeded with this one as parent).
    """

    def __init__(self, env: Env, imports: dict[str, str]):
        self.env = env
        self.imports = imports

    def _bind_target(self, target: ast.expr, level: int) -> None:
        if isinstance(target, ast.Name):
            self.env.set(target.id, level)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, level)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, level)
        # attribute/subscript targets don't create local names

    def visit_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            level = classify(stmt.value, self.env, self.imports)
            for t in stmt.targets:
                self._bind_target(t, level)
                if isinstance(t, ast.Name) and isinstance(
                        stmt.value, (ast.Tuple, ast.List, ast.Set)):
                    self.env.containers.add(t.id)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if _annotation_is_static(stmt.annotation):
                level = STATIC
            else:
                level = classify(stmt.value, self.env, self.imports)
            self._bind_target(stmt.target, level)
        elif isinstance(stmt, ast.AugAssign):
            level = max(classify(stmt.value, self.env, self.imports),
                        classify(stmt.target, self.env, self.imports)
                        if isinstance(stmt.target, ast.Name) else STATIC)
            container = (isinstance(stmt.target, ast.Name)
                         and self.env.is_container(stmt.target.id))
            self._bind_target(stmt.target, level)
            if container:                     # tensors += [...] stays a list
                self.env.containers.add(stmt.target.id)
        elif isinstance(stmt, ast.For):
            it = classify(stmt.iter, self.env, self.imports)
            self._bind_target(stmt.target, it)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, UNKNOWN)
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for a in stmt.names:
                self.env.set(a.asname or a.name.split(".")[0], STATIC)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.env.set(stmt.name, STATIC)


def function_statements(node, *, into_bodies: bool = True):
    """Yield the function's own statements, not those of nested defs.

    With ``into_bodies`` the walk descends into if/for/while/try/with
    blocks (still skipping nested function/class bodies).
    """
    stack = list(node.body)
    while stack:
        stmt = stack.pop(0)
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if into_bodies:
            for field_name in ("body", "orelse", "finalbody", "handlers"):
                block = getattr(stmt, field_name, None)
                if not block:
                    continue
                for sub in block:
                    if isinstance(sub, ast.ExceptHandler):
                        stack.extend(sub.body)
                    else:
                        stack.append(sub)


def walk_expressions(stmt: ast.stmt):
    """Yield expression nodes of a statement without entering nested defs
    or sub-statements (those come through ``function_statements``)."""
    blocks = {"body", "orelse", "finalbody", "handlers"}
    stack: list[ast.AST] = []
    for field_name, value in ast.iter_fields(stmt):
        if field_name in blocks and isinstance(stmt, (ast.If, ast.For,
                                                      ast.While, ast.Try,
                                                      ast.With, ast.AsyncWith)):
            continue
        if isinstance(value, ast.AST):
            stack.append(value)
        elif isinstance(value, list):
            stack.extend(v for v in value if isinstance(v, ast.AST))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


__all__ = ["STATIC", "UNKNOWN", "TENSOR", "Env", "param_env", "classify", "is_display",
           "EnvBuilder", "function_statements", "walk_expressions",
           "is_host_target"]
