"""Rule base class and the port's scopes."""
from __future__ import annotations

import re

from ..engine import Finding, ModuleContext


class Rule:
    """One named check.  Subclasses set ``id``/``name``/``description`` and
    implement ``check``; ``scope`` is a tuple of path-regex fragments the
    rule is limited to (empty = every file)."""

    id: str = "REP999"
    name: str = "unnamed"
    description: str = ""
    scope: tuple[str, ...] = ()

    def applies(self, path: str) -> bool:
        if not self.scope:
            return True
        return any(re.search(pat, path) for pat in self.scope)

    def check(self, ctx: ModuleContext) -> list[Finding]:   # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node, message: str) -> Finding:
        return Finding(rule=self.id, name=self.name, path=ctx.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


#: scope of the trace-safety family: the hot-path modules where a host sync
#: stalls the host behind the card, or fails a CUDA-graph capture (serving
#: engine, model forward, kernel wrappers).  Driver and test code may sync.
TRACE_SCOPE = (r"src/repro_torch/serving/", r"src/repro_torch/models/",
               r"src/repro_torch/kernels/")

#: scope of the control-plane determinism family: the JAX package's scope
#: moved over, with nothing added (``serving/fleet.py`` times replicas by the
#: wall clock on purpose: the provisioning delay it measures is real time).
CONTROL_PLANE_SCOPE = (r"src/repro_torch/core/chaos/",
                       r"src/repro_torch/core/convergence/",
                       r"src/repro_torch/core/scaling/")
