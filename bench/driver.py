"""The front end: drives ``ServingEngine.submit`` and ``step`` for one
window and records, on the host clock, what each request and each step
did.

* Open loop (``chat-long``, ``tweet-burst``): a request is submitted when
  it comes due, whatever the engine is doing, and is timed from that due
  time.  ``step()`` runs once per loop iteration: one mixed iteration, the
  cadence of a server that returns every token.  Once the window has
  closed, no request is sent and the loop runs until every request of the
  window has finished or the drain deadline passes.
* Offline (``offline-batch``): the whole backlog is submitted when the
  window opens and ``step(decode_steps=ServeConfig.decode_steps)`` runs
  until it closes.

Every stamp is taken after ``step`` returns, which follows the engine's
copy of the step's results to the host (a device sync), so a first token
is stamped after the step that emitted it, with that step's compute.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.serving.engine import Request


@dataclass
class ReqRec:
    req: Request
    due: float                 # seconds after the window opened
    admit: float | None = None  # start of the first step in which it held a slot
    first: float | None = None
    done: float | None = None
    n_out: int = 0


@dataclass
class StepRec:
    t0: float
    t1: float
    iters: int                 # mixed iterations the step ran
    served: int                # rows served (ServingEngine.step's return)
    rows: list = field(default_factory=list)   # (committed before, after) per row
    emitted: int = 0           # tokens emitted
    pages_used: int = 0        # KV pages held after the step


class Window:
    """One window's loop over one engine; ``hook(now)`` runs before each
    step (the tracer starts and stops there)."""

    def __init__(self, eng, *, k: int, hook=None, clock=time.perf_counter):
        self.eng = eng
        self.k = k
        self.hook = hook
        self.clock = clock
        self.recs: dict[int, ReqRec] = {}
        self.steps: list[StepRec] = []
        self.origin = 0.0
        self.close = 0.0           # when the window closed, seconds after it opened
        self.deadline = 0.0

    def now(self) -> float:
        return self.clock() - self.origin

    def submit(self, a) -> None:
        req = Request(rid=a.rid, prompt=a.prompt, max_new_tokens=a.max_new_tokens)
        self.recs[a.rid] = ReqRec(req=req, due=a.due_s)
        self.eng.submit(req)

    def step(self) -> None:
        eng = self.eng
        before = {req.rid: int(eng.pos[s]) for s, req in eng.active.items()}
        n_done = len(eng.completed)
        it0 = eng.step_count
        if self.hook is not None:
            self.hook(self.now())
        t0 = self.now()
        served = eng.step(decode_steps=self.k)
        t1 = self.now()
        rec = StepRec(t0=t0, t1=t1, iters=eng.step_count - it0, served=served)
        touched = [(req, int(eng.pos[s])) for s, req in eng.active.items()]
        touched += [(req, len(req.prompt) + len(req.output) - 1)
                    for req in eng.completed[n_done:]]
        for req, after in touched:
            r = self.recs[req.rid]
            rec.rows.append((before.get(req.rid, 0), after))
            if r.admit is None:
                r.admit = t0
            n = len(req.output)
            rec.emitted += n - r.n_out
            r.n_out = n
            if n and r.first is None:
                r.first = t1
            if req.done_s is not None and r.done is None:
                r.done = t1
        if eng.paged:
            rec.pages_used = eng.kv.num_pages - 1 - eng.kv.n_free
        self.steps.append(rec)

    def run_open(self, arrivals, seconds: float, drain_s: float) -> None:
        eng = self.eng
        self.deadline = seconds + drain_s
        pending = sorted(arrivals, key=lambda a: a.due_s)
        i = 0
        self.origin = self.clock()
        while True:
            now = self.now()
            while i < len(pending) and pending[i].due_s <= now:
                self.submit(pending[i])
                i += 1
            if now >= seconds and (now >= self.deadline
                                   or all(r.done is not None for r in self.recs.values())):
                break
            if not eng.active and not eng.queue:
                if i == len(pending):
                    if now >= seconds:
                        break
                    time.sleep(min(seconds - now, 0.005))
                else:
                    time.sleep(max(min(pending[i].due_s - now, 0.005), 0.0))
                continue
            self.step()
        self.close = seconds

    def run_offline(self, arrivals, seconds: float) -> None:
        for a in arrivals:
            self.submit(a)
        self.origin = self.clock()
        while self.now() < seconds:
            self.step()
        self.close = self.now()
        self.deadline = self.close


__all__ = ["ReqRec", "StepRec", "Window"]
