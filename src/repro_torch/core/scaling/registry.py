"""Tiny policy registry: name -> factory, so launchers, benchmarks and configs
can name policies (``--policy target``) without importing their classes.

`repro_torch.core.autoscaler.policies` registers the built-ins at import time.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:  # runtime import is deferred: policies.py imports this module
    from repro_torch.core.autoscaler.base import Policy

_FACTORIES: dict[str, Callable[..., Policy]] = {}


def register_policy(name: str, factory: Callable[..., Policy] | None = None):
    """Register a policy factory.  Usable directly or as a class decorator:

        @register_policy("threshold")
        class ThresholdPolicy(Policy): ...
    """
    def _register(fn: Callable[..., Policy]):
        if name in _FACTORIES:
            raise ValueError(f"policy {name!r} already registered")
        _FACTORIES[name] = fn
        return fn

    if factory is not None:
        return _register(factory)
    return _register


def make_policy(name: str, **kwargs) -> Policy:
    """Instantiate a registered policy by name."""
    import repro_torch.core.autoscaler.policies  # noqa: F401  (built-in registrations)
    if name not in _FACTORIES:
        raise KeyError(f"unknown policy {name!r}; known: {available_policies()}")
    return _FACTORIES[name](**kwargs)


def available_policies() -> tuple[str, ...]:
    import repro_torch.core.autoscaler.policies  # noqa: F401
    return tuple(sorted(_FACTORIES))


__all__ = ["available_policies", "make_policy", "register_policy"]
