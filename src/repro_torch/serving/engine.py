"""Single-replica serving engine: the mixed chunked-prefill / speculative
path and the bucketed-prefill path over the paged KV pool, and the
dense-cache fallback.

Counterpart of ``repro.serving.engine`` (see its docstring).
``Request.score`` is the application-output signal: the running mean
log-probability of the tokens the model generated, which the serve driver
feeds to the control plane's ``output_score`` channel.

* **Mixed step** (``chunked_prefill=True``, the default): requests are
  admitted with no prefill dispatch; every engine step runs the mixed loop
  over the fixed ``max_batch``-wide slot array, in which each row either
  streams its next span-sized prompt chunk or verifies a drafted token block
  (n-gram proposer + longest-agreeing-prefix acceptance).
* **Bucketed prefill** (``chunked_prefill=False``): queued prompts sharing a
  power-of-two bucket are coalesced into one fixed-width ``prefill`` call
  (padding rows and bucket overhang scatter into the trash page; a partial
  group waits at most ``bucket_max_wait`` engine steps for bucket-mates),
  then a K-step greedy decode loop advances the active slots, compacted and
  padded to a power-of-two batch.
* **Dense-cache fallback** (``paged=False``, and the families without a
  paged decode path: ssm): each admitted request is prefilled alone and its
  cache installed into its slot's rows of one dense cache; every engine
  step runs the same K-step greedy decode loop over all ``max_batch``
  slots, idle ones computing garbage that the live mask discards.  The
  hybrid family is refused: its reference ``decode_step`` takes one
  position for all rows, and this loop decodes rows at their own positions.

The JAX ``lax.while_loop`` of each path is a Python loop here, with one host
sync per iteration (``live.any()``) so the loop exits as early as the
reference's and ``step_count`` stays equal to it.  Per-row state stays on
the device between iterations.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.decode_attention import autotune
from repro_torch.kernels.sampling.ops import greedy_epilogue
from repro_torch.models.registry import Model, resolve_device
from repro_torch.serving.kvcache import TRASH_PAGE, PagedKVCache, write_prefill_pages
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
class MigratedRequest:
    """One in-flight request lifted off a draining replica: the request, its
    decode progress, and its committed KV pages as host tensors (None when
    nothing is committed yet -- the importer replays the prompt)."""

    req: Request
    pos: int                           # committed KV positions on the source
    remaining: int                     # decode budget left (NOT max_new_tokens)
    kv_chunks: object                  # {name: (L, h, ps, *rest)} or None


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 1024
    eos_token: int = -1                # -1: run to max_new_tokens
    greedy: bool = True                # read by neither package: both decode greedily
    paged: bool = True                 # paged KV cache (attention families)
    page_size: int | None = None       # None: per-device default (autotune)
    num_pages: int | None = None       # default: max_batch*(max_len/ps) + trash
    decode_steps: int = 8              # loop iterations per host round trip
    prefill_batch: int | None = None   # coalesced prefill width (None: max_batch)
    # -- mixed chunked-prefill / speculative decode --
    chunked_prefill: bool = True       # fold prefill chunks into the decode loop
    chunk_size: int | None = None      # prefill tokens per mixed step (None: autotune)
    draft_len: int | None = None       # speculative tokens per step (None: autotune;
                                       # 0 disables speculation)
    proposer: str = "ngram"            # draft proposer kind (speculate.make_proposer)
    ngram: int = 2                     # n-gram order for the lookup proposer
    lmhead_block_v: int | None = None  # the reference's fused lm-head vocab tile (None:
                                       # autotune); stored, and ignored by the CUDA
                                       # lm-head, which picks its own 128-column tiles
    # -- bucketed-prefill path (chunked_prefill=False) --
    bucket_max_wait: int = 4           # engine steps a partial bucket group may
                                       # wait for bucket-mates before flushing


class ServingEngine:
    """Synchronous continuous batcher (slot-based) on one device.

    ``step()`` advances the active slots by up to ``decode_steps`` loop
    iterations (mixed, or greedy decode on the bucketed path); finished
    slots release their pages and are refilled from the queue.
    ``run_until_drained`` runs at the full ``cfg.decode_steps`` cadence.
    ``device`` must match the model's (default: the GPU).
    """

    def __init__(self, model: Model, params, cfg: ServeConfig, *, device=None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} != model device "
                             f"{model.device}")
        self.paged = cfg.paged and model.supports_paged
        if not self.paged and model.cfg.family == "hybrid":
            raise NotImplementedError(
                "the dense-cache engine cannot serve the hybrid family: its "
                "decode_step takes one position for all rows (as "
                "repro.models.mamba_lm.decode_step does), while the engine decodes "
                "each row at its own position; the reference engine fails the "
                "same way (ROADMAP.md Queue 3, reference caveats)")
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
        self.prefill_batch = int(cfg.prefill_batch or cfg.max_batch)
        self._prefill_rows = 0                     # real rows batched-prefilled
        self._prefill_width = 0                    # padded rows dispatched
        self._bucket_stats: dict[int, list] = {}   # bucket -> [rows, width]
        self._bucket_first_wait: dict[int, int] = {}   # bucket -> first defer step
        self._clock = 0                            # ticks every step() call
        self.chunked = (self.paged and cfg.chunked_prefill
                        and model.verify_step is not None)
        dev = self.device.type
        if self.chunked:
            chunk = cfg.chunk_size or autotune.default_chunk_size(dev)
            draft = (cfg.draft_len if cfg.draft_len is not None
                     else autotune.default_draft_len(dev))
            self.spec_len = max(int(draft), 0)
            self.span = max(int(chunk), self.spec_len + 1, 1)
            # stored as the reference stores it; the CUDA lm-head tiles by itself
            self.lmhead_block_v = (cfg.lmhead_block_v if cfg.lmhead_block_v is not None
                                   else autotune.default_lmhead_block_v(dev))
            self.proposer = (make_proposer(cfg.proposer, self.span - 1, ngram=cfg.ngram)
                             if self.span > 1 else None)
        else:
            self.spec_len = 0
            self.span = 1
            self.proposer = None
        self._mixed_emitted = 0                    # tokens emitted by mixed loop
        self._mixed_live_iters = 0                 # live-row loop iterations
        if self.paged:
            page_size = cfg.page_size or autotune.default_page_size(dev)
            self.kv = PagedKVCache(model.init_cache, max_batch=cfg.max_batch,
                                   max_len=cfg.max_len, page_size=page_size,
                                   num_pages=cfg.num_pages)
        else:
            self.kv = None
            self.cache = None                      # dense cache, built at first install

    # -- the bucketed path: prefill and the K-step decode loop ------------------------

    # replint-torch: traced -- the engine's prefill step
    def _paged_prefill_fn(self, pages, toks, last_idx, page_ids):
        """Batched bucketed prefill: toks (nb, pb) zero-padded rows sharing
        one bucket pb (nb is the fixed ``prefill_batch`` width).  Scatters
        each prompt's KV into its pages (bucket overhang and padding rows
        land in the trash page) and returns each row's greedy first token
        with its logprob."""
        logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                           max_len=int(toks.shape[1]),
                                           last_idx=last_idx)
        tok, lp = greedy_epilogue(logits[:, 0])
        write_prefill_pages(pages, cache, page_ids)
        return tok, lp, pages

    # replint-torch: traced -- the engine's decode loop
    def _decode_loop(self, kv, toks, pos, rem, live, n_steps: int, step_fn):
        """Up to ``n_steps`` greedy decode steps on the device.

        Carried state: the KV storage (the paged pool or the dense cache,
        written in place), last tokens (na, 1), per-row positions / remaining
        budgets, the live mask (rows park when their budget runs out or they
        emit eos -- their KV writes keep landing in storage they still own,
        or in the trash page, harmlessly),
        the emitted-token buffer and running logprob sums.  The loop exits
        early once every row parks."""
        K = self.decode_steps
        na = toks.shape[0]
        dev = toks.device
        eos = int(self.cfg.eos_token)
        out_toks = torch.full((na, K), -1, dtype=torch.long, device=dev)
        lp_sum = torch.zeros((na,), dtype=torch.float32, device=dev)
        n_emit = torch.zeros((na,), dtype=torch.long, device=dev)
        i = 0
        # one host sync per iteration: the early exit keeps step_count equal
        # to the reference's; a device-side exit is ROADMAP item 2
        # replint-torch: disable=TRC101 -- loop exit, ROADMAP item 2
        while i < n_steps and bool(live.any()):
            logits, kv = step_fn(kv, toks, pos)
            tok, lp = greedy_epilogue(logits[:, 0])
            tok = tok.long()
            out_toks[:, i] = torch.where(live, tok, -1)
            inc = live.long()
            rem = rem - inc
            lp_sum = lp_sum + torch.where(live, lp, 0.0)
            toks = torch.where(live, tok, toks[:, 0])[:, None]
            nxt_live = live & (rem > 0)
            if eos >= 0:
                nxt_live = nxt_live & (tok != eos)
            pos = pos + inc
            n_emit = n_emit + inc
            live = nxt_live
            i += 1
        return kv, out_toks, lp_sum, n_emit, pos, rem, i

    # replint-torch: traced -- the engine's decode step
    def _paged_decode_fn(self, pages, toks, pos, rem, live, tbl, n_steps: int):
        """K-step decode loop for a compacted active-slot batch (padding
        rows carry the trash-page table and write/attend harmlessly)."""
        return self._decode_loop(
            pages, toks, pos, rem, live, n_steps,
            lambda kv, tk, ps: self.model.decode_step(self.params, kv, tk, ps,
                                                      block_table=tbl))

    # -- the dense-cache fallback --------------------------------------------------

    # replint-torch: traced -- the engine's dense prefill step
    def _dense_prefill_fn(self, batch):
        """One request's prefill -> (greedy first token, its logprob, the
        request's cache with batch dim 1)."""
        logits, cache1 = self.model.prefill(self.params, batch, max_len=self.cfg.max_len)
        tok, lp = greedy_epilogue(logits[:, -1])
        return tok[0], lp[0], cache1

    # replint-torch: traced -- the engine's dense decode step
    def _dense_decode_fn(self, cache, toks, pos, rem, live, n_steps: int):
        """K-step decode loop over the full dense cache -- idle slots compute
        garbage that the live mask discards."""
        return self._decode_loop(
            cache, toks, pos, rem, live, n_steps,
            lambda kv, tk, ps: self.model.decode_step(self.params, kv, tk, ps))

    # -- the mixed step -------------------------------------------------------------

    # replint-torch: traced -- the engine's mixed step
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
        # to the reference's; a device-side exit is ROADMAP item 2
        # replint-torch: disable=TRC101 -- loop exit, ROADMAP item 2
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
        if self.paged and self.kv.pages_needed(total) > self.kv.num_pages - 1:
            raise ValueError(
                f"request {req.rid} needs more pages than the pool holds")
        self.queue.append(req)

    @property
    def n_in_system(self) -> int:
        return len(self.queue) + len(self.active)

    @property
    def prefill_occupancy(self) -> float:
        """Real rows per dispatched prefill row (1.0 = no padding waste)."""
        return self._prefill_rows / max(self._prefill_width, 1)

    @property
    def bucket_occupancy(self) -> dict[int, float]:
        """Per-bucket prefill occupancy (bucketed path only; the chunked
        path has no padded prefill rows to waste)."""
        return {pb: rows / max(width, 1)
                for pb, (rows, width) in sorted(self._bucket_stats.items())}

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
        if self.paged and (self.kv.held[slot] or self.kv.worst[slot]):
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

    # -- migration (a fleet's drain path) ------------------------------------------
    def export_request(self, slot: int) -> MigratedRequest:
        """Lift the in-flight request off ``slot`` for migration: copy its
        committed KV pages to the host, free the slot, and return everything
        :meth:`import_request` needs to resume it elsewhere bit-identically.
        Call only at a step boundary.  Chunked engines only -- the mixed loop
        rebuilds history from prompt + output, so per-row state transfers
        without a dense cache copy."""
        if not self.chunked:
            raise RuntimeError("migration requires the chunked paged engine")
        req = self.active.pop(slot)
        pos = int(self.pos[slot])
        chunks = self.kv.export_slot(slot) if pos > 0 else None
        m = MigratedRequest(req=req, pos=pos, remaining=int(self.remaining[slot]),
                            kv_chunks=chunks)
        self._reset_slot(slot)
        return m

    def can_import(self) -> bool:
        """True if a migrated request could be admitted right now (free slot
        under the cap; page admission is checked per request at import)."""
        return len(self.active) < min(self.slot_limit, self.cfg.max_batch)

    def import_request(self, m: MigratedRequest) -> int:
        """Re-admit a migrated request with its committed KV installed.  The
        decode budget resumes at the exported ``remaining``; the mixed loop
        then continues from ``pos`` exactly as the source would have.
        Returns the slot."""
        if not self.chunked:
            raise RuntimeError("migration requires the chunked paged engine")
        if not self.can_import():
            raise RuntimeError("no free slot under the cap for import")
        total = len(m.req.prompt) + m.req.max_new_tokens - 1
        if not self.kv.can_admit(total):
            raise RuntimeError("page pool cannot admit the migrated request")
        slot = next(s for s in range(self.cfg.max_batch) if s not in self.active)
        if self.kv.held[slot] or self.kv.worst[slot]:
            self._reset_slot(slot)       # reclaim a force-popped slot's pages
        if m.pos > 0 and m.kv_chunks is not None:
            self.kv.import_slot(slot, m.kv_chunks, total)
        else:
            self.kv.reserve(slot, total)
        self.pos[slot] = m.pos
        self.remaining[slot] = m.remaining
        self.active[slot] = m.req
        return slot

    # -- scheduling ---------------------------------------------------------------
    def _note_prefilled(self, slot: int, req: Request, install: bool,
                        tok: int, logp: float, now: float) -> int:
        """Post-prefill bookkeeping: record the first token and its score;
        either finish at fill time (the prefill token was the whole budget)
        or install the request into its slot.  Returns 1 for a fill-time
        completion, else 0."""
        req.output.append(tok)
        req.first_token_s = now
        req.score += (logp - req.score) / len(req.output)
        if not install:
            # the prefill token is the whole budget: finish at fill time
            # (a decode here would emit max_new_tokens + 1 tokens)
            req.done_s = now
            self.completed.append(req)
            return 1
        self.pos[slot] = len(req.prompt)
        self.remaining[slot] = req.max_new_tokens - 1
        self.active[slot] = req
        return 0

    def _prefill_group(self, group, pb: int, now: float) -> int:
        """One batched bucketed prefill over ``group`` [(slot, req, install)]
        rows sharing bucket ``pb``; returns the number of fill-time
        completions (single-token budgets spent by the prefill argmax)."""
        width = self.prefill_batch
        n_chunks = pb // self.kv.page_size
        toks = np.zeros((width, pb), np.int64)
        last_idx = np.zeros((width,), np.int64)
        page_ids = np.full((width, n_chunks), TRASH_PAGE, np.int32)
        for j, (slot, req, install) in enumerate(group):
            plen = len(req.prompt)
            toks[j, :plen] = req.prompt
            last_idx[j] = plen - 1
            if install:
                total = plen + req.max_new_tokens - 1
                page_ids[j] = self.kv.alloc_prefill(slot, plen, total, n_chunks)
        dev = self.device
        tokv, lpv, self.kv.pages = self._paged_prefill_fn(
            self.kv.pages, torch.from_numpy(toks).to(dev),
            torch.from_numpy(last_idx).to(dev), torch.from_numpy(page_ids).to(dev))
        tokv = tokv.cpu().numpy()
        lpv = lpv.cpu().numpy()
        self._prefill_rows += len(group)
        self._prefill_width += width
        stats = self._bucket_stats.setdefault(pb, [0, 0])
        stats[0] += len(group)
        stats[1] += width
        fill_done = 0
        for j, (slot, req, install) in enumerate(group):
            fill_done += self._note_prefilled(slot, req, install,
                                              int(tokv[j]), float(lpv[j]), now)
        return fill_done

    def _dense_prefill_into(self, slot: int, req: Request, install: bool):
        """Dense path: one prefill per request, its cache installed into the
        slot's rows of the dense cache (batch dim 1 of every leaf)."""
        prompt = torch.from_numpy(np.asarray(req.prompt, np.int64)).to(self.device)
        tok, logp, cache1 = self._dense_prefill_fn({"tokens": prompt[None]})
        if install:
            if self.cache is None:
                self.cache = {k: c.new_zeros((c.shape[0], self.cfg.max_batch) + c.shape[2:])
                              for k, c in cache1.items()}
            for k, full in self.cache.items():
                full[:, slot] = cache1[k][:, 0]
        return int(tok), float(logp)

    def _prefill_bucket(self, req: Request) -> int:
        # bucket >= page_size so the padded prompt is a whole number of
        # page chunks (both are powers of two; max_len is page-aligned)
        return min(max(_bucket(len(req.prompt)), self.kv.page_size),
                   self.cfg.max_len)

    def _fill_slots(self, now: float) -> int:
        """Refill free slots from the queue under the slot cap.  Returns the
        number of requests that finished at fill time (a max_new_tokens
        budget spent by the prefill token).

        Chunked: reserve each request's worst-case pages and hand the prompt
        to the mixed loop (no prefill dispatch).  Bucketed: coalesce
        same-bucket head-of-queue prompts into batched prefill calls; a
        fill-time completion still consumes its slot for this step, so the
        slot cap bounds prefill work exactly like decode work."""
        limit = min(self.slot_limit, self.cfg.max_batch)
        free = [s for s in range(self.cfg.max_batch) if s not in self.active]
        if self.paged:
            # reclaim pages of slots that were force-popped without release()
            for s in free:
                if self.kv.held[s] or self.kv.worst[s]:
                    self._reset_slot(s)
        fill_done = 0
        while free and self.queue and len(self.active) + fill_done < limit:
            req = self.queue[0]
            if req.max_new_tokens <= 0:
                # nothing to generate: complete without a prefill or a slot
                self.queue.pop(0)
                req.done_s = now
                self.completed.append(req)
                continue
            if not self.paged:
                install = req.max_new_tokens > 1
                self.queue.pop(0)
                slot = free.pop(0)
                tok, logp = self._dense_prefill_into(slot, req, install)
                self._prefill_rows += 1            # dense fills one at a time
                self._prefill_width += 1
                fill_done += self._note_prefilled(slot, req, install, tok, logp, now)
                continue
            if self.chunked:
                total = len(req.prompt) + req.max_new_tokens - 1
                if not self.kv.can_admit(total):
                    break                # defer until completions free pages
                self.queue.pop(0)
                slot = free.pop(0)
                self.kv.reserve(slot, total)
                self.pos[slot] = 0
                self.remaining[slot] = req.max_new_tokens
                self.active[slot] = req
                continue
            # bucketed: collect a same-bucket FIFO group for one batched prefill
            pb = self._prefill_bucket(req)
            group: list[tuple[int, Request, bool]] = []
            planned = 0                  # worst-case pages promised to group
            blocked = False
            while (self.queue and free and len(group) < self.prefill_batch
                   and len(self.active) + fill_done + len(group) < limit):
                r = self.queue[0]
                if r.max_new_tokens <= 0:
                    self.queue.pop(0)
                    r.done_s = now
                    self.completed.append(r)
                    continue
                if self._prefill_bucket(r) != pb:
                    break                # next bucket fills in the next group
                install = r.max_new_tokens > 1
                total = len(r.prompt) + r.max_new_tokens - 1
                if install and not self.kv.can_admit(total, planned):
                    blocked = True       # defer until completions free pages
                    break
                if install:
                    planned += self.kv.pages_needed(total)
                self.queue.pop(0)
                group.append((free.pop(0), r, install))
            if not group:
                break                    # head of queue blocked on pages
            full = (len(group) >= self.prefill_batch or not free
                    or len(self.active) + fill_done + len(group) >= limit)
            if (not full and not blocked and self.cfg.bucket_max_wait > 0
                    and (self.active or fill_done)):
                # partial group while the engine has other work: wait for
                # bucket-mates to raise occupancy -- but never beyond
                # ``bucket_max_wait`` engine steps, so a lone request in a
                # cold bucket cannot starve behind a busy decode batch
                first = self._bucket_first_wait.setdefault(pb, self._clock)
                if self._clock - first < self.cfg.bucket_max_wait:
                    for slot, r, _ in reversed(group):
                        free.insert(0, slot)
                        self.queue.insert(0, r)
                    break
            self._bucket_first_wait.pop(pb, None)
            fill_done += self._prefill_group(group, pb, now)
            if blocked:
                break
        return fill_done

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

    def _decode_active_paged(self, now: float, k: int = 1) -> tuple[int, int]:
        """Up to ``k`` batched greedy decode steps over the active slots
        only, compacted and padded to a power-of-two batch (padding rows
        carry the trash table), in one device loop.  Returns (slots served,
        device steps executed)."""
        slots = sorted(self.active)
        n = len(slots)
        if n == 0:
            return 0, 0
        na = 1 << max(int(np.ceil(np.log2(n))), 0)
        toks = np.zeros((na, 1), np.int64)
        posv = np.zeros((na,), np.int64)
        remv = np.zeros((na,), np.int64)
        livev = np.zeros((na,), bool)
        tblv = np.zeros((na, self.kv.pages_per_slot), np.int32)
        for i, s in enumerate(slots):
            # pre-allocate every page the next k on-device writes may touch
            span = min(k, int(self.remaining[s]))
            self.kv.ensure_writable_span(s, int(self.pos[s]), max(span, 1))
            toks[i, 0] = self.active[s].output[-1]
            posv[i] = self.pos[s]
            remv[i] = self.remaining[s]
            livev[i] = True
            tblv[i] = self.kv.block_table[s]
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        self.kv.pages, out_toks, lp_sum, n_emit, pos_out, rem_out, iters = \
            self._paged_decode_fn(self.kv.pages, put(toks), put(posv), put(remv),
                                  put(livev), put(tblv), k)
        self._apply_decode_outputs(list(enumerate(slots)), out_toks, lp_sum,
                                   n_emit, pos_out, rem_out, now)
        return n, int(iters)

    def _decode_all_dense(self, now: float, k: int = 1) -> tuple[int, int]:
        """Dense fallback: up to ``k`` batched decode steps over every slot of
        the dense cache (idle slots compute garbage that is discarded).
        Returns (slots served, device steps executed)."""
        slots = sorted(self.active)
        if not slots:
            return 0, 0                  # guard: empty active set
        na = self.cfg.max_batch
        toks = np.zeros((na, 1), np.int64)
        livev = np.zeros((na,), bool)
        for slot, req in self.active.items():
            toks[slot, 0] = req.output[-1]
            livev[slot] = True
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        self.cache, out_toks, lp_sum, n_emit, pos_out, rem_out, iters = \
            self._dense_decode_fn(self.cache, put(toks), put(self.pos.astype(np.int64)),
                                  put(self.remaining.astype(np.int64)), put(livev), k)
        self._apply_decode_outputs([(s, s) for s in slots], out_toks, lp_sum, n_emit,
                                   pos_out, rem_out, now)
        return len(slots), int(iters)

    def step(self, now: float | None = None, *,
             decode_steps: int | None = None) -> int:
        """One engine step: refill + one batched device loop over the active
        slots (``decode_steps`` iterations, default 1).  Returns the number
        of slots that served work this step (loop rows plus fill-time
        completions)."""
        now = time.monotonic() if now is None else now
        k = max(int(decode_steps or 1), 1)
        if k > self.decode_steps:
            # the emitted-token buffer is cfg.decode_steps wide; silently
            # clamping would make a driver's virtual clock drift
            raise ValueError(
                f"decode_steps={k} > ServeConfig.decode_steps="
                f"{self.decode_steps}; raise the config to burst this far")
        self._clock += 1
        fill_done = self._fill_slots(now)
        if not self.active:
            if fill_done:
                self.step_count += 1
            return fill_done
        if self.chunked:
            served, iters = self._decode_active_mixed(now, k)
        elif self.paged:
            served, iters = self._decode_active_paged(now, k)
        else:
            served, iters = self._decode_all_dense(now, k)
        self.step_count += max(iters, 1)
        return served + fill_done

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        """Drain queue + active set at the full ``cfg.decode_steps`` cadence."""
        for _ in range(max_steps):
            if not self.queue and not self.active:
                return
            self.step(decode_steps=self.decode_steps)
        raise RuntimeError("engine failed to drain")


__all__ = ["MigratedRequest", "Request", "ServeConfig", "ServingEngine"]
