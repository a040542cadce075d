"""replint-torch rule registry.

Rule ids are grouped by family, as in ``repro.lint.rules``:

* ``TRC1xx`` trace safety (host syncs, tensor control flow, tensor printing)
* ``KRN2xx`` CUDA kernel launches (grad guard, aliasing, stream, fallback),
  the counterpart of the JAX package's ``PLK2xx`` Pallas rules
* ``CPL3xx`` control-plane invariants (determinism, units, encapsulation)
* ``REP0xx`` meta (suppression hygiene) -- emitted by the engine itself
"""
from __future__ import annotations

from .base import Rule
from .controlplane import CONTROL_PLANE_RULES
from .kernels import KERNEL_RULES
from .trace import TRACE_RULES

#: every checkable rule, in id order
ALL_RULES: list[Rule] = sorted(
    TRACE_RULES + KERNEL_RULES + CONTROL_PLANE_RULES, key=lambda r: r.id)

#: engine-emitted meta rules, documented here so --list-rules shows them
META_RULES: list[tuple[str, str, str]] = [
    ("REP001", "suppress-no-reason",
     "every '# replint-torch: disable=...' needs a '-- reason' string"),
    ("REP002", "unused-suppression",
     "a suppression that matches no finding must be removed"),
]


def get_rule(id_or_name: str) -> Rule | None:
    for rule in ALL_RULES:
        if rule.id == id_or_name or rule.name == id_or_name:
            return rule
    return None


__all__ = ["Rule", "ALL_RULES", "META_RULES", "get_rule"]
