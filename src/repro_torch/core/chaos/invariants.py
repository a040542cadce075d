"""Invariant checkers: what "recovered correctly" means, mechanically.

Each checker returns a list of :class:`Violation` records (empty == the
invariant holds) instead of raising, so a drill can run every check and
report the full set of breakages at once.  The four invariants together say
a faulted run is *observationally equivalent* to a fault-free one:

1. exactly-once   -- no admitted request is lost or duplicated;
2. bit-identical  -- surviving outputs match the no-fault reference
                     token-for-token;
3. KV conservation -- the page free list balances on every live engine and
                     drained engines handed every page back;
4. audit replay   -- the sealed log loads clean, capacity replay matches,
                     and re-running the pure planner over the logged inputs
                     reproduces the converger's decisions byte-for-byte
                     with no step against a superseded generation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from ..convergence.audit import (
    AuditIntegrityError, AuditLog, replay, verify_plan_replay,
)


@dataclass(frozen=True)
class Violation:
    """One broken invariant: a short id plus a human-readable account."""

    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"{self.invariant}: {self.detail}"


def check_exactly_once(admitted_rids: Iterable[int], completed,
                       *, final: bool = True) -> list[Violation]:
    """Every admitted request id completes exactly once.

    ``completed`` is the run's completion list (requests with ``rid``,
    ``output`` and ``done_s``).  With ``final=False`` (mid-drill) only
    duplicates and phantom completions are violations -- requests still in
    flight are expected; with ``final=True`` a missing completion is a lost
    request.
    """
    violations: list[Violation] = []
    seen: dict[int, int] = {}
    for r in completed:
        seen[r.rid] = seen.get(r.rid, 0) + 1
        if final and (r.done_s is None or not r.output):
            violations.append(Violation(
                "exactly_once",
                f"request {r.rid} completed without "
                f"{'a done timestamp' if r.done_s is None else 'output'}"))
    admitted = set(admitted_rids)
    for rid in sorted(admitted):
        n = seen.pop(rid, 0)
        if n == 0 and final:
            violations.append(Violation(
                "exactly_once", f"request {rid} admitted but never "
                "completed (lost in a kill/drain)"))
        elif n > 1:
            violations.append(Violation(
                "exactly_once", f"request {rid} completed {n} times "
                "(re-admission duplicated it)"))
    for rid, n in sorted(seen.items()):
        violations.append(Violation(
            "exactly_once",
            f"request {rid} completed {n}x but was never admitted"))
    return violations


def check_outputs_match(completed, reference) -> list[Violation]:
    """Faulted-run outputs equal the fault-free reference, token-for-token.

    Kills restart work from scratch and drains migrate committed KV
    bit-identically, so greedy decode must land on the same tokens either
    way; any divergence means recovery corrupted state.
    """
    violations: list[Violation] = []
    ref = {r.rid: tuple(r.output) for r in reference}
    for r in completed:
        want = ref.get(r.rid)
        if want is None:
            violations.append(Violation(
                "bit_identical",
                f"request {r.rid} has no fault-free reference output"))
            continue
        got = tuple(r.output)
        if got != want:
            at = next((i for i, (a, b) in enumerate(zip(got, want))
                       if a != b), min(len(got), len(want)))
            violations.append(Violation(
                "bit_identical",
                f"request {r.rid} diverges from the reference at token "
                f"{at} ({len(got)} vs {len(want)} tokens)"))
    return violations


def check_kv_conservation(pool, *, drained: bool = False) -> list[Violation]:
    """Page accounting balances on every engine that still exists.

    Serving engines must pass the cache's own conservation check (no leak,
    no double-ownership, reservation ledger consistent).  Replicas retired
    via *drain* must have returned every page to the free list -- migration
    may not strand KV.  Killed replicas (retired without the ``draining``
    flag) are skipped: the host is gone, and their in-flight pages were
    re-reserved from scratch elsewhere, which the serving-side checks cover.
    With ``drained=True`` (end of drill, backlog empty) serving engines
    must also be back to a fully free pool.
    """
    violations: list[Violation] = []

    def fully_free(rep) -> bool:
        return rep.eng.kv.n_free == rep.eng.kv.num_pages - 1

    for rep in pool.serving:
        try:
            rep.eng.kv.check_invariants()
        except AssertionError as e:
            violations.append(Violation(
                "kv_conservation", f"replica{rep.rix}: {e}"))
        if drained and not fully_free(rep):
            kv = rep.eng.kv
            violations.append(Violation(
                "kv_conservation",
                f"replica{rep.rix}: {kv.num_pages - 1 - kv.n_free} pages "
                "still held after the drill drained"))
    for rep in pool.retired:
        if rep.draining and not fully_free(rep):
            kv = rep.eng.kv
            violations.append(Violation(
                "kv_conservation",
                f"drained replica{rep.rix} stranded "
                f"{kv.num_pages - 1 - kv.n_free} pages"))
    return violations


def check_audit(path: str, final_state=None) -> list[Violation]:
    """The sealed audit log is intact and replays to the converger's
    actual decisions.

    Three layers: (a) ``load(verify=True)`` -- seal present, count and CRC
    match (a truncated or edited tail is reported, mirroring the checkpoint
    store's ``.ok`` marker); (b) capacity replay equals ``final_state``
    (per-pool ``{"live", "pending"}``) when given; (c)
    :func:`~repro_torch.core.convergence.audit.verify_plan_replay` -- the pure
    planner, re-run on each plan record's logged inputs, reproduces the
    logged steps with no stale-generation plan.
    """
    try:
        records = AuditLog.load(path, verify=True)
    except AuditIntegrityError as e:
        return [Violation("audit_replay", str(e))]
    violations: list[Violation] = []
    if final_state is not None:
        replayed = replay(records)
        for name, want in final_state.items():
            got = replayed.get(name)
            if got != dict(want):
                violations.append(Violation(
                    "audit_replay",
                    f"pool {name!r}: replay gives {got}, plan holds "
                    f"{dict(want)}"))
    checked, mismatches = verify_plan_replay(records)
    for m in mismatches:
        violations.append(Violation(
            "audit_replay",
            f"record {m['index']}: {m['kind']} mismatch -- "
            + (f"plan gen {m['logged']} vs latest desired gen {m['latest']}"
               if m["kind"] == "generation"
               else f"logged {m['logged']} != replayed {m['replayed']}")))
    if checked == 0 and final_state is not None:
        violations.append(Violation(
            "audit_replay", "no plan record carried replayable inputs"))
    return violations


__all__ = [
    "Violation",
    "check_audit",
    "check_exactly_once",
    "check_kv_conservation",
    "check_outputs_match",
]
