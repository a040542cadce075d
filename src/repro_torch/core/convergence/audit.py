"""Append-only structured audit log for the convergence plane.

Every state transition the converger either caused (steps) or witnessed
(landings, revocations, injected faults) becomes one flat JSON record, so an
operator -- or a test -- can reconstruct *why* the fleet looks the way it
does.  Record kinds:

* ``init``     -- starting live units per pool
* ``desired``  -- a new desired state was set (per-pool targets + reason)
* ``events``   -- witnessed meter deltas since the last converge call:
  ``landed`` / ``revoked`` / ``lost`` / ``overflow_landed`` per pool
* ``plan``     -- the steps the planner emitted this tick
* ``step``     -- one executed step and its outcome (kind, pool, asked,
  applied, plus ``queued`` for replacements)
* ``backoff`` / ``gave_up`` -- retry bookkeeping on stuck pools
* ``decision`` -- the policy decision that produced a desired change

:func:`replay` folds the records back into per-pool ``{live, pending}``
state; tests and the fault benchmark assert it matches the actual final
``CapacityPlan`` state, which proves the log is a complete account of every
capacity transition.
"""
from __future__ import annotations

import json
import zlib
from typing import IO, Iterable, Mapping


class AuditIntegrityError(ValueError):
    """The on-disk audit log is corrupt, truncated, or unsealed."""


class AuditLog:
    """In-memory audit trail, optionally mirrored to an append-only JSONL file.

    :meth:`seal` appends a terminal record carrying the payload record count
    and a CRC over every preceding serialized line -- the JSONL analogue of
    the checkpoint store's ``.ok`` marker: a log whose last record is not a
    matching seal was cut off (or edited) mid-incident, and
    ``load(path, verify=True)`` reports exactly where.
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._records: list[dict] = []
        self._crc = 0
        self._fh: IO[str] | None = open(path, "a") if path else None

    @property
    def records(self) -> list[dict]:
        return self._records

    def append(self, time: float, kind: str, **payload) -> dict:
        rec = {"t": float(time), "kind": str(kind), **payload}
        line = json.dumps(rec, sort_keys=True)
        self._records.append(rec)
        self._crc = zlib.crc32(line.encode(), self._crc)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def seal(self, time: float) -> dict:
        """Terminal marker: record count + CRC of everything before it.
        Must be the last record -- appending after a seal invalidates it."""
        n, crc = len(self._records), self._crc
        return self.append(time, "seal", n=n, crc=crc)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @staticmethod
    def load(path: str, verify: bool = False) -> list[dict]:
        """Read a JSONL audit log back.  With ``verify=True`` the log must
        end in a valid :meth:`seal` record whose count and CRC match the
        preceding lines; corrupt, truncated, or unsealed logs raise
        :class:`AuditIntegrityError` naming the offending line."""
        records: list[dict] = []
        crc = 0
        with open(path) as fh:
            for lineno, line in enumerate(fh, start=1):
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError as e:
                    if verify:
                        raise AuditIntegrityError(
                            f"{path}:{lineno}: corrupt record "
                            f"({e.msg}); the tail of this log cannot be "
                            f"trusted") from e
                    raise
                if records[-1].get("kind") != "seal":
                    crc = zlib.crc32(line.rstrip("\n").encode(), crc)
        if not verify:
            return records
        if not records or records[-1].get("kind") != "seal":
            raise AuditIntegrityError(
                f"{path}: no terminal seal record -- the log was truncated "
                f"or the run never completed (last kind: "
                f"{records[-1]['kind'] if records else 'none'!r})")
        seal = records[-1]
        n = len(records) - 1
        if seal.get("n") != n:
            raise AuditIntegrityError(
                f"{path}: seal claims {seal.get('n')} records but "
                f"{n} precede it -- lines were dropped or injected")
        if any(r.get("kind") == "seal" for r in records[:-1]):
            raise AuditIntegrityError(
                f"{path}: records were appended after a seal")
        if seal.get("crc") != crc:
            raise AuditIntegrityError(
                f"{path}: payload CRC mismatch (seal {seal.get('crc')}, "
                f"recomputed {crc}) -- a record was altered in place")
        return records


def replay(records: Iterable[Mapping]) -> dict[str, dict[str, int]]:
    """Fold audit records into final per-pool ``{"live": n, "pending": n}``.

    Only capacity-bearing kinds move state (``init`` / ``events`` / ``step``);
    everything else is narrative.  The result must equal the plan's actual
    final state -- see ``tests/test_convergence.py`` and the fault benchmark.
    """
    state: dict[str, dict[str, int]] = {}

    def pool(name: str) -> dict[str, int]:
        return state.setdefault(name, {"live": 0, "pending": 0})

    for rec in records:
        kind = rec["kind"]
        if kind == "init":
            for name, live in rec["pools"].items():
                state[name] = {"live": int(live), "pending": 0}
        elif kind == "events":
            p = pool(rec["pool"])
            landed = int(rec.get("landed", 0))
            p["live"] += landed - int(rec.get("revoked", 0)) - int(
                rec.get("lost", 0))
            p["pending"] -= landed + int(rec.get("overflow_landed", 0))
        elif kind == "step":
            p = pool(rec["pool"])
            step = rec["step"]
            applied = int(rec.get("applied", 0))
            if step == "LaunchUnit":
                p["pending"] += applied
            elif step == "CancelPending":
                p["pending"] -= applied
            elif step == "DrainUnit":
                p["live"] -= applied
            elif step == "ReplaceUnhealthy":
                p["live"] -= applied
                p["pending"] += int(rec.get("queued", 0))
    return state


def verify_plan_replay(records: Iterable[Mapping]) -> tuple[int, list[dict]]:
    """Re-run the pure planner over every ``plan`` record's logged inputs and
    compare against the steps the converger actually recorded.

    Each ``plan`` record carries the full planner inputs (observed stats,
    overdue counts, blocked sets) and the generation of the desired state it
    served; ``desired`` records carry targets + bounds + generation.  Because
    ``plan_steps`` is pure, replaying those inputs must reproduce the logged
    steps byte-for-byte -- and every plan's generation must equal the latest
    desired generation at that point (a stale-generation plan is a converger
    acting on superseded intent).

    Returns ``(n_plans_checked, mismatches)``; an empty mismatch list is the
    proof.  Each mismatch dict names the record index, the divergence kind
    (``steps`` or ``generation``), and the logged-vs-replayed values.
    """
    from repro_torch.core.scaling.capacity import PoolStats

    from .desired import DesiredGroup, PoolTarget
    from .planner import plan_steps, step_record

    desired: DesiredGroup | None = None
    checked = 0
    mismatches: list[dict] = []
    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind == "desired":
            bounds = rec.get("bounds", {})
            desired = DesiredGroup(
                {n: PoolTarget(target=int(t),
                               min_units=int(bounds.get(n, (0, 4096))[0]),
                               max_units=int(bounds.get(n, (0, 4096))[1]))
                 for n, t in rec["targets"].items()},
                generation=int(rec.get("gen", 0)))
        elif kind == "plan":
            inputs = rec.get("inputs")
            if inputs is None or desired is None:
                continue    # pre-generation log: nothing to replay against
            if int(rec.get("gen", 0)) != desired.generation:
                mismatches.append({
                    "index": i, "kind": "generation",
                    "logged": rec.get("gen"), "latest": desired.generation})
            stats = {n: PoolStats(units=int(s["units"]),
                                  pending=int(s["pending"]),
                                  cost_rate=0.0,
                                  min_units=int(s["min_units"]),
                                  unhealthy=int(s["unhealthy"]))
                     for n, s in inputs["stats"].items()}
            steps = plan_steps(
                desired, stats,
                overdue={n: int(v) for n, v in inputs["overdue"].items()},
                launch_blocked=set(inputs["launch_blocked"]),
                replace_blocked=set(inputs["replace_blocked"]))
            replayed = [step_record(s) for s in steps]
            logged = [{k: v for k, v in s.items()} for s in rec["steps"]]
            checked += 1
            if replayed != logged:
                mismatches.append({"index": i, "kind": "steps",
                                   "logged": logged, "replayed": replayed})
    return checked, mismatches


__all__ = ["AuditIntegrityError", "AuditLog", "replay", "verify_plan_replay"]
