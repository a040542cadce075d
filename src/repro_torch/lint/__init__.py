"""replint-torch -- the port's static analysis, counterpart of ``repro.lint``.

Three rule families guard what the port's hot path rests on: the serving
step never waits for the card by accident (TRC1xx: a host sync stalls the
enqueue, and fails a CUDA-graph capture), every CUDA kernel launch is
guarded, unaliased, on the current stream and never hidden by a fallback
(KRN2xx, the counterpart of the Pallas rules), and the control plane stays
deterministic and replayable (CPL3xx).  Comments use ``# replint-torch:``,
not ``# replint:`` (see ``engine``).

Run it::

    PYTHONPATH=src python -m repro_torch.lint
    PYTHONPATH=src python -m repro_torch.lint --selftest
"""
from .engine import Finding, Report, lint_paths
from .rules import ALL_RULES, get_rule

__all__ = ["Finding", "Report", "lint_paths", "ALL_RULES", "get_rule"]
