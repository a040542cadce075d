"""Single-replica serving engine, mixed chunked-prefill / speculative path.

Counterpart of ``repro.serving.engine`` (see its docstring).  Requests are
admitted with no prefill dispatch: every engine step runs the mixed loop
over the fixed ``max_batch``-wide slot array, in which each row either
streams its next span-sized prompt chunk or verifies a drafted token block
(n-gram proposer + longest-agreeing-prefix acceptance).  ``Request.score``
is the application-output signal: the running mean log-probability of the
tokens the model generated, which the serve driver feeds to the control
plane's ``output_score`` channel.

The JAX ``lax.while_loop`` is a Python loop here, with one host sync per
iteration (``live.any()``) so the loop exits as early as the reference's.
Per-row state stays on the device between iterations.

Not ported yet (ROADMAP.md Queue 1): the bucketed prefill path
(``chunked_prefill=False``), the dense-cache fallback (``paged=False``) and
request migration (``export_request`` / ``import_request``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.decode_attention import autotune
from repro_torch.models.registry import Model, resolve_device
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.speculate import make_proposer, prefix_len


def _bucket(n: int) -> int:
    """Power-of-two length bucket, floor 16."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 4)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    # filled by the engine
    first_token_s: float | None = None
    done_s: float | None = None
    output: list = field(default_factory=list)
    score: float = 0.0                 # running mean logprob of emitted tokens

    @property
    def request_class(self) -> tuple[int, int]:
        """(prefill bucket, decode bucket) -- the service-demand class."""
        return _bucket(len(self.prompt)), _bucket(self.max_new_tokens)


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 1024
    eos_token: int = -1                # -1: run to max_new_tokens
    paged: bool = True                 # only the paged cache is ported
    page_size: int | None = None       # None: per-device default (autotune)
    num_pages: int | None = None       # default: max_batch*(max_len/ps) + trash
    decode_steps: int = 8              # mixed-loop iterations per host round trip
    chunked_prefill: bool = True       # only the chunked path is ported
    chunk_size: int | None = None      # prefill tokens per mixed step (None: autotune)
    draft_len: int | None = None       # speculative tokens per step (None: autotune;
                                       # 0 disables speculation)
    proposer: str = "ngram"            # draft proposer kind (speculate.make_proposer)
    ngram: int = 2                     # n-gram order for the lookup proposer


class ServingEngine:
    """Synchronous continuous batcher (slot-based) on one device.

    ``step()`` runs up to ``decode_steps`` mixed iterations over the active
    slots; finished slots release their pages and are refilled from the
    queue.  ``run_until_drained`` runs at the full ``cfg.decode_steps``
    cadence.  ``device`` must match the model's (default: the GPU).
    """

    def __init__(self, model: Model, params, cfg: ServeConfig, *, device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model device "
                             f"{model.device}")
        if not (cfg.paged and cfg.chunked_prefill):
            raise NotImplementedError(
                "only the paged chunked-prefill path is ported; the bucketed "
                "and dense paths are ROADMAP.md Queue 1 items")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}       # slot -> request
        # dynamic cap on concurrently active slots (<= cfg.max_batch): the unit
        # of elasticity the scaling control plane actuates on this engine
        self.slot_limit: int = cfg.max_batch
        self.pos = np.zeros(cfg.max_batch, dtype=np.int32)
        self.remaining = np.zeros(cfg.max_batch, dtype=np.int32)
        self.completed: list[Request] = []
        self.step_count = 0
        self.decode_steps = max(int(cfg.decode_steps), 1)
        dev = self.device.type
        chunk = cfg.chunk_size or autotune.default_chunk_size(dev)
        draft = (cfg.draft_len if cfg.draft_len is not None
                 else autotune.default_draft_len(dev))
        self.spec_len = max(int(draft), 0)
        self.span = max(int(chunk), self.spec_len + 1, 1)
        self.proposer = (make_proposer(cfg.proposer, self.span - 1, ngram=cfg.ngram)
                         if self.span > 1 else None)
        self._mixed_emitted = 0                    # tokens emitted by mixed loop
        self._mixed_live_iters = 0                 # live-row loop iterations
        page_size = cfg.page_size or autotune.default_page_size(dev)
        self.kv = PagedKVCache(model.init_cache, max_batch=cfg.max_batch,
                               max_len=cfg.max_len, page_size=page_size,
                               num_pages=cfg.num_pages)

    # -- the mixed step -------------------------------------------------------------

    def _mixed_step_fn(self, pages, hist, ell, pos, rem, live, tbl, n_steps: int):
        """Up to ``n_steps`` mixed chunked-prefill / speculative-decode
        iterations on the device: one ``verify_step`` per iteration serves
        every row, whatever phase it is in.

        Per-row state is the committed token history ``hist`` (prompt +
        emitted; garbage past ``ell``) and the committed-KV count ``pos``.
        Block position j carries ``hist[pos + j]`` where known (a prefill
        chunk) and a proposer draft where not (speculation); the longest
        prefix whose context was right (``raw_valid``) is committed KV, and
        verifier outputs at committed positions past ``ell - 1`` are
        emitted, capped by the draft budget, the token budget and eos.  See
        the JAX counterpart for the full argument.

        The JAX scatters with ``mode="drop"`` are masked ``index_put_`` here:
        dropped lanes are sent to one sink element past the real buffer.
        """
        K = self.decode_steps
        T = self.span
        na, H = hist.shape
        dev = hist.device
        eos = int(self.cfg.eos_token)
        cap = min(T, 1 + self.spec_len)    # emitted tokens per row per step
        OUT = K * cap
        jr = torch.arange(T, device=dev)[None, :]
        rows = torch.arange(na, device=dev)[:, None]
        verify = self.model.verify_step
        hist_buf = torch.cat([hist.reshape(-1), hist.new_zeros(1)])   # + sink
        hist = hist_buf[:na * H].view(na, H)
        out_buf = torch.full((na * OUT + 1,), -1, dtype=torch.long, device=dev)
        lp_sum = torch.zeros((na,), dtype=torch.float32, device=dev)
        n_emit = torch.zeros((na,), dtype=torch.long, device=dev)
        live_iters = torch.zeros((), dtype=torch.long, device=dev)

        i = 0
        # one host sync per iteration: the early exit keeps step_count equal
        # to the reference's
        while i < n_steps and bool(live.any()):
            idx = pos[:, None] + jr                           # (na, T)
            known = idx < ell[:, None]
            u = torch.gather(hist, 1, idx.clamp(0, H - 1))
            if T > 1:
                drafts = self.proposer(hist, ell)             # (na, T-1)
                didx = (idx - ell[:, None]).clamp(0, T - 2)
                u = torch.where(known, u, torch.gather(drafts, 1, didx))
            tok, lp, pages = verify(self.params, pages, u, pos, block_table=tbl)
            tok = tok.long()
            # acceptance: block position j is in-sequence iff known, or its
            # token equals the verifier's output after position j-1
            if T > 1:
                prev_ok = torch.cat([torch.ones((na, 1), dtype=torch.bool, device=dev),
                                     u[:, 1:] == tok[:, :-1]], dim=1)
                raw_valid = prefix_len(known | prev_ok)       # (na,) >= 1
            else:
                raw_valid = torch.ones((na,), dtype=torch.long, device=dev)
            # emission: verifier outputs at committed positions >= ell-1,
            # capped by draft budget, token budget, and (emitted) eos
            krank = jr - (ell - 1 - pos)[:, None]             # emission rank
            cand = ((krank >= 0) & (jr < raw_valid[:, None])
                    & (krank < rem.clamp(max=cap)[:, None]) & live[:, None])
            if eos >= 0:
                eos_hit = cand & (tok == eos)
                emit = cand & (torch.cumsum(eos_hit.long(), dim=1) - eos_hit.long() == 0)
                ate_eos = (eos_hit & emit).any(dim=1)
            else:
                emit = cand
                ate_eos = torch.zeros((na,), dtype=torch.bool, device=dev)
            n_new = emit.sum(dim=1)
            # extend hist / the output buffer with the emitted tokens
            col = ell[:, None] + krank
            hidx = torch.where(emit, rows * H + col.clamp(0, H - 1), na * H)
            hist_buf.index_put_((hidx.reshape(-1),), tok.reshape(-1))
            ocol = n_emit[:, None] + krank
            oidx = torch.where(emit, rows * OUT + ocol.clamp(0, OUT - 1), na * OUT)
            out_buf.index_put_((oidx.reshape(-1),), tok.reshape(-1))
            ell_n = ell + n_new
            # committed KV advances by the accepted prefix but never past the
            # last committed token: accepted-but-unemitted drafts roll back
            pos = torch.where(live, torch.minimum(pos + raw_valid, ell_n - 1), pos)
            rem = rem - n_new
            lp_sum = lp_sum + (lp * emit).sum(dim=1)
            n_emit = n_emit + n_new
            live_iters = live_iters + live.sum()
            live = live & (rem > 0) & ~ate_eos
            ell = ell_n
            i += 1
        return (pages, out_buf[:na * OUT].view(na, OUT), lp_sum, n_emit, pos,
                rem, i, live_iters)

    # -- queue interface ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + max(req.max_new_tokens, 1) - 1
        if total > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} new tokens needs {total} cache slots "
                f"> max_len {self.cfg.max_len}")
        if self.kv.pages_needed(total) > self.kv.num_pages - 1:
            raise ValueError(
                f"request {req.rid} needs more pages than the pool holds")
        self.queue.append(req)

    @property
    def n_in_system(self) -> int:
        return len(self.queue) + len(self.active)

    @property
    def speculation_stats(self) -> dict[str, float]:
        """Mixed-loop throughput counters: tokens emitted, live-row loop
        iterations, and their ratio (tokens per row-step; > 1 means
        speculation is beating one-token-per-step decode)."""
        return {
            "emitted": float(self._mixed_emitted),
            "live_iters": float(self._mixed_live_iters),
            "tokens_per_row_step": (self._mixed_emitted
                                    / max(self._mixed_live_iters, 1)),
        }

    # -- slot lifecycle -----------------------------------------------------------
    def _reset_slot(self, slot: int) -> None:
        """Release a slot's pages and reservation, zero its registers."""
        if self.kv.held[slot] or self.kv.worst[slot]:
            self.kv.release(slot)
        self.pos[slot] = 0
        self.remaining[slot] = 0

    def evict(self, slot: int) -> Request:
        """Straggler mitigation: pull the request off its slot, free the
        slot's pages, and re-enqueue from scratch (backup dispatch)."""
        req = self.active.pop(slot)
        self._reset_slot(slot)
        req.output.clear()
        req.score = 0.0
        req.first_token_s = None
        self.submit(req)
        return req

    # -- scheduling ---------------------------------------------------------------
    def _fill_slots(self, now: float) -> None:
        """Admit queued requests into free slots under the slot cap: reserve
        their worst-case pages and hand the prompt to the mixed loop, which
        streams it in span-sized chunks (no prefill dispatch)."""
        limit = min(self.slot_limit, self.cfg.max_batch)
        free = [s for s in range(self.cfg.max_batch) if s not in self.active]
        # reclaim pages of slots that were force-popped without release()
        for s in free:
            if self.kv.held[s] or self.kv.worst[s]:
                self._reset_slot(s)
        while free and self.queue and len(self.active) < limit:
            req = self.queue[0]
            if req.max_new_tokens <= 0:
                # nothing to generate: complete without a slot
                self.queue.pop(0)
                req.done_s = now
                self.completed.append(req)
                continue
            total = len(req.prompt) + req.max_new_tokens - 1
            if not self.kv.can_admit(total):
                break                    # defer until completions free pages
            self.queue.pop(0)
            slot = free.pop(0)
            self.kv.reserve(slot, total)
            self.pos[slot] = 0
            self.remaining[slot] = req.max_new_tokens
            self.active[slot] = req

    def _finish(self, slot: int, now: float) -> None:
        req = self.active.pop(slot)
        req.done_s = now
        self.completed.append(req)
        self._reset_slot(slot)

    def _apply_decode_outputs(self, rows, out_toks, lp_sum, n_emit, pos_out,
                              rem_out, now: float) -> None:
        """Fold one device-loop sync back into host bookkeeping.
        ``rows``: [(batch row, slot)]."""
        out_toks = out_toks.cpu().numpy()
        lp_sum = lp_sum.cpu().numpy()
        n_emit = n_emit.cpu().numpy()
        pos_out = pos_out.cpu().numpy()
        rem_out = rem_out.cpu().numpy()
        finished = []
        for i, s in rows:
            # position/budget always advance (a row can commit prefill
            # chunks without emitting a single token)
            self.pos[s] = int(pos_out[i])
            self.remaining[s] = int(rem_out[i])
            ne = int(n_emit[i])
            if ne == 0:
                continue
            req = self.active[s]
            prev = len(req.output)
            if prev == 0:
                req.first_token_s = now
            req.output.extend(int(t) for t in out_toks[i, :ne])
            req.score = (req.score * prev + float(lp_sum[i])) / (prev + ne)
            if rem_out[i] <= 0 or req.output[-1] == self.cfg.eos_token:
                finished.append(s)
        for s in finished:
            self._finish(s, now)

    def _decode_active_mixed(self, now: float, k: int = 1) -> tuple[int, int]:
        """Up to ``k`` mixed steps over the active slots in one device loop
        at the full fixed ``max_batch`` width (dead rows carry the trash
        table).  Returns (slots served, loop iterations)."""
        slots = sorted(self.active)
        n = len(slots)
        if n == 0:
            return 0, 0
        na = self.cfg.max_batch
        T = self.span
        H = self.cfg.max_len + 1           # prompt + every emitted token
        hist = np.zeros((na, H), np.int64)
        ellv = np.zeros((na,), np.int64)
        posv = np.zeros((na,), np.int64)
        remv = np.zeros((na,), np.int64)
        livev = np.zeros((na,), bool)
        tblv = np.zeros((na, self.kv.pages_per_slot), np.int32)
        for i, s in enumerate(slots):
            req = self.active[s]
            plen = len(req.prompt)
            hist[i, :plen] = req.prompt
            if req.output:
                hist[i, plen:plen + len(req.output)] = req.output
            ellv[i] = plen + len(req.output)
            total = plen + req.max_new_tokens - 1
            # pre-allocate every page the next k on-device spans may write;
            # writes past ``total`` hit TRASH table entries harmlessly
            span = min(k * T, total - int(self.pos[s]))
            self.kv.ensure_writable_span(s, int(self.pos[s]), max(span, 1))
            posv[i] = self.pos[s]
            remv[i] = self.remaining[s]
            livev[i] = True
            tblv[i] = self.kv.block_table[s]
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        (self.kv.pages, out_toks, lp_sum, n_emit, pos_out, rem_out, iters,
         live_iters) = self._mixed_step_fn(
            self.kv.pages, put(hist), put(ellv), put(posv), put(remv),
            put(livev), put(tblv), k)
        self._apply_decode_outputs(list(enumerate(slots)), out_toks, lp_sum,
                                   n_emit, pos_out, rem_out, now)
        self._mixed_emitted += int(n_emit.sum())
        self._mixed_live_iters += int(live_iters)
        # KV rollback: hand back pages that only ever held rejected
        # speculative writes (the next span re-appends them if accepted)
        for s in slots:
            if s in self.active:
                self.kv.shrink_to(s, max(int(self.pos[s]), 1))
        return n, int(iters)

    def step(self, now: float | None = None, *,
             decode_steps: int | None = None) -> int:
        """One engine step: refill + one batched device loop over the active
        slots (``decode_steps`` iterations, default 1).  Returns the number
        of slots that served work this step."""
        now = time.monotonic() if now is None else now
        k = max(int(decode_steps or 1), 1)
        if k > self.decode_steps:
            # the emitted-token buffer is cfg.decode_steps wide; silently
            # clamping would make a driver's virtual clock drift
            raise ValueError(
                f"decode_steps={k} > ServeConfig.decode_steps="
                f"{self.decode_steps}; raise the config to burst this far")
        self._fill_slots(now)
        if not self.active:
            return 0
        served, iters = self._decode_active_mixed(now, k)
        self.step_count += max(iters, 1)
        return served

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Drain queue + active set at the full ``cfg.decode_steps`` cadence."""
        for _ in range(max_steps):
            if not self.queue and not self.active:
                return
            self.step(decode_steps=self.decode_steps)
        raise RuntimeError("engine failed to drain")

    def export_request(self, slot: int):
        raise NotImplementedError(
            "request migration is not ported yet (ROADMAP.md Queue 1)")

    def import_request(self, m):
        raise NotImplementedError(
            "request migration is not ported yet (ROADMAP.md Queue 1)")


__all__ = ["Request", "ServeConfig", "ServingEngine"]
