"""Paged KV cache: block-table storage + the cache ops the serving paths
run on (paged, and the dense ``(B, S_max, ...)`` cache of ``paged=False``).

Counterpart of ``repro.serving.kvcache`` (see its docstring for the pool's
free-list discipline).  The serving engine's KV memory is a pool of
fixed-size *pages* (``page_size`` tokens each), shared by every slot.
``block_table[s, i]`` is the physical page holding logical positions
``[i*ps, (i+1)*ps)`` of slot ``s``.  Page 0 is the reserved TRASH page: it
is never allocated and absorbs the writes of dead rows.

Where the JAX code rebuilt the pool functionally (``.at[].set``), the port
writes pages in place with ``index_copy_``: the pool is the largest tensor
of a serving replica, and a copy per layer per step would double it.

Several writes may land on one trash slot.  The JAX package calls them
garbage, and for a dense model they are: no live row reads page 0.  In a
MoE layer, though, idle rows (which attend page 0) share expert capacity
with live rows, so page 0's contents reach the tokens.  Every paged write
therefore resolves duplicates to the last write in row-major order -- the
order of the CPU's sequential scatter, and of the JAX package's on the CPU
-- so the card writes the same bits in every run (:func:`_last_writer`),
for every family.  The slots a step writes depend only on its block table
and positions, so :class:`PagedOps` computes them and their last-writer
order once a step and reuses them for every layer, k and v.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

TRASH_PAGE = 0


def _last_writer(idx: torch.Tensor, n_slots: int) -> torch.Tensor:
    """For each write of ``idx`` (slot indices in ``[0, n_slots)``), the
    position of the last write to the same slot: gathering the sources
    through it makes every duplicate write copy the same value, so the
    result does not depend on the order the device runs them in."""
    order = torch.arange(idx.numel(), device=idx.device)
    last = torch.full((n_slots,), -1, dtype=torch.long, device=idx.device)
    return last.scatter_reduce_(0, idx, order, reduce="amax")[idx]


# ---------------------------------------------------------------------------------
# device-side page ops
# ---------------------------------------------------------------------------------

def _token_slots(block_table: torch.Tensor, pos: torch.Tensor, ps: int) -> torch.Tensor:
    """(B,) flat pool slots of one token per row at logical ``pos[b]``; a
    position past the table takes the last table entry, as the JAX gather's
    index clamping does."""
    B, n = block_table.shape
    p = pos.long()
    rows = torch.arange(B, device=p.device)
    return block_table.long()[rows, (p // ps).clamp(max=n - 1)] * ps + p % ps


def _span_slots(block_table: torch.Tensor, pos: torch.Tensor, T: int, ps: int) -> torch.Tensor:
    """(B * T,) flat pool slots, row-major, of a T-token span per row from
    logical ``pos[b]``; positions past the table are clamped to the row's
    last logical slot."""
    n = block_table.shape[1]
    span = torch.arange(T, device=pos.device)
    p = (pos.long()[:, None] + span[None, :]).clamp(0, n * ps - 1)   # (B, T)
    pages = torch.gather(block_table.long(), 1, p // ps)              # (B, T)
    return (pages * ps + p % ps).reshape(-1)


def _scatter(cache: torch.Tensor, src: torch.Tensor, idx: torch.Tensor,
             last: torch.Tensor) -> torch.Tensor:
    """Write rows of ``src`` (N, *rest) into the pool's flat slots ``idx``
    (N,), in place; ``last`` (:func:`_last_writer` of ``idx``) makes every
    duplicate copy the last writer's row."""
    P, ps = cache.shape[0], cache.shape[1]
    cache.view((P * ps,) + cache.shape[2:]).index_copy_(0, idx, src[last].to(cache.dtype))
    return cache


# replint-torch: traced -- called from the model's decode step
def paged_update(cache: torch.Tensor, new: torch.Tensor,
                 block_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter one new token per batch row into the page pool, in place.

    cache: (P, ps, *rest), contiguous; new: (B, 1, *rest); block_table:
    (B, n); pos: (B,) logical write positions.  Rows whose table entry is
    the trash page write harmlessly into page 0, the last such row's write
    winning (module docstring).  A position past the table (a parked full
    row) takes the last table entry, as the JAX gather's index clamping
    does; such a row's KV is never read again.  Returns ``cache``.
    """
    P, ps = cache.shape[0], cache.shape[1]
    idx = _token_slots(block_table, pos, ps)
    return _scatter(cache, new[:, 0], idx, _last_writer(idx, P * ps))


# replint-torch: traced -- called from the model's verify step
def paged_update_span(cache: torch.Tensor, new: torch.Tensor,
                      block_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Scatter a span of ``T`` new tokens per batch row into the page pool,
    in place.

    cache: (P, ps, *rest), contiguous; new: (B, T, *rest); block_table:
    (B, n); pos: (B,) logical positions of each row's span start -- row b
    writes logical positions [pos[b], pos[b] + T).  Positions past a row's
    allocated pages hit TRASH table entries and land in page 0; positions
    past the table itself are clamped to the row's last logical slot, whose
    entry is TRASH unless the row is full -- and a full row only overflows
    after it has parked, when its KV is never read again.  Duplicate writes
    resolve to the last one in row-major order (module docstring).  Returns
    ``cache``.
    """
    P, ps = cache.shape[0], cache.shape[1]
    B, T = new.shape[0], new.shape[1]
    idx = _span_slots(block_table, pos, T, ps)
    return _scatter(cache, new.reshape((B * T,) + cache.shape[2:]), idx,
                    _last_writer(idx, P * ps))


# replint-torch: traced -- called from the model's decode step
def paged_gather(cache: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Reconstruct the dense per-slot view from the page pool.

    cache: (P, ps, *rest); block_table: (B, n) -> (B, n*ps, *rest); entry j
    of row b is logical position j of slot b (table order == logical order).
    """
    P, ps = cache.shape[0], cache.shape[1]
    rest = cache.shape[2:]
    B, n = block_table.shape
    flat = cache.reshape((P * ps,) + rest)
    offs = torch.arange(ps, device=block_table.device)
    idx = (block_table.long()[:, :, None] * ps + offs[None, None, :]).reshape(B, n * ps)
    return flat[idx]


# replint-torch: traced -- called from the serving engine's prefill step
def write_prefill_pages(pages: dict, cache: dict, page_ids: torch.Tensor) -> dict:
    """Scatter a batched prefill cache into the pool, page-chunked, in place.

    pages: {name: (L, P, ps, *rest)}; cache: matching {name: (L, B, pb,
    *rest)} with pb a multiple of ps; page_ids: (B, pb // ps) (or
    (pb // ps,) for B == 1) -- real pages first, trash (0) for the bucket
    overhang past each prompt.  Real page ids are unique across rows
    (free-list ownership).  Several rows may scatter their overhang into the
    trash page; the last of them wins (:func:`_last_writer`), in every run:
    padding rows of a later MoE decode step attend page 0, and their
    routing shares expert capacity with live rows.  Returns ``pages``.
    """
    pg0 = next(iter(pages.values()))
    ids = page_ids.reshape(-1).long().to(pg0.device)
    last = _last_writer(ids, pg0.shape[1])          # every leaf has the same pages
    for name, pg in pages.items():
        c = cache[name]
        L, ps = pg.shape[0], pg.shape[2]
        B, nc = c.shape[1], c.shape[2] // ps
        chunks = c.reshape((L, B * nc, ps) + pg.shape[3:])[:, last]
        pg.index_copy_(1, ids, chunks.to(pg.dtype))
    return pages


# replint-torch: traced -- called from the model's decode step
def _vector_mask(seq_len: int, pos: torch.Tensor, window: int) -> torch.Tensor:
    """(B, 1, S) validity mask for one query per row at logical ``pos[b]``:
    keys k <= pos[b] (minus the sliding window, when ``window`` > 0).  The
    T = 1 slice of :func:`_span_mask`."""
    k_pos = torch.arange(seq_len, device=pos.device)
    valid = k_pos[None, :] < pos.long()[:, None] + 1                   # (B, S)
    if window > 0:
        valid &= k_pos[None, :] > pos.long()[:, None] - window
    return valid[:, None, :]


# replint-torch: traced -- called from the model's verify step
def _span_mask(seq_len: int, pos: torch.Tensor, q_len: int,
               window: int) -> torch.Tensor:
    """(B, T, S) causal mask for a T-token span starting at per-row ``pos``:
    query j of row b sits at logical position pos[b] + j and attends keys
    k <= pos[b] + j (minus the sliding window, when ``window`` > 0)."""
    k_pos = torch.arange(seq_len, device=pos.device)                  # (S,)
    q_pos = pos.long()[:, None] + torch.arange(q_len, device=pos.device)[None, :]
    valid = k_pos[None, None, :] <= q_pos[:, :, None]                 # (B, T, S)
    if window > 0:
        valid &= k_pos[None, None, :] > q_pos[:, :, None] - window
    return valid


@dataclass
class DenseScalarOps:
    """Uniform-position dense cache (B, S_max, *rest): every row writes at
    the same position ``pos`` (an int or a 0-d tensor), in place.  ``device``
    places the mask (a scalar position carries none)."""

    device: torch.device | None = None

    def write(self, cache, new, pos):
        # a start past the end is clamped as lax.dynamic_update_slice does
        p = min(int(pos), cache.shape[1] - 1)
        cache[:, p] = new[:, 0].to(cache.dtype)
        return cache

    def view(self, cache):
        return cache

    def mask(self, seq_len, pos, window):
        k_pos = torch.arange(seq_len, device=self.device)
        valid = k_pos < int(pos) + 1
        if window > 0:
            valid &= k_pos > int(pos) - window
        return valid[None, :]                                          # (Sq=1, S)


class DenseVectorOps:
    """Heterogeneous-position dense cache (B, S_max, *rest): row b writes at
    ``pos[b]``, in place."""

    def write(self, cache, new, pos):
        rows = torch.arange(cache.shape[0], device=cache.device)
        p = pos.long().to(cache.device).clamp(max=cache.shape[1] - 1)
        cache[rows, p] = new[:, 0].to(cache.dtype)
        return cache

    def view(self, cache):
        return cache

    def mask(self, seq_len, pos, window):
        return _vector_mask(seq_len, pos, window)


@dataclass
class PagedOps:
    """Block-table paged cache: pool leaves are (P, ps, *rest), shared by all
    rows; logical order is recovered by gathering in table order.

    One instance serves one step: the slots of its writes and their
    last-writer order (module docstring) depend only on the table and
    ``pos``, so they are computed on the first write and reused by every
    later write with the same ``pos`` tensor and pool shape -- each layer's
    k and v, and the int8 scales."""

    block_table: torch.Tensor                                          # (B, n)
    _plans: dict = field(default_factory=dict, repr=False)

    def _plan(self, cache, pos, T: int | None):
        P, ps = cache.shape[0], cache.shape[1]
        key = (P, ps, T)
        plan = self._plans.get(key)
        if plan is None or plan[0] is not pos:
            idx = (_token_slots(self.block_table, pos, ps) if T is None
                   else _span_slots(self.block_table, pos, T, ps))
            plan = self._plans[key] = (pos, idx, _last_writer(idx, P * ps))
        return plan[1:]

    def write(self, cache, new, pos):
        return _scatter(cache, new[:, 0], *self._plan(cache, pos, None))

    def write_span(self, cache, new, pos):
        B, T = new.shape[0], new.shape[1]
        return _scatter(cache, new.reshape((B * T,) + cache.shape[2:]),
                        *self._plan(cache, pos, T))

    def view(self, cache):
        return paged_gather(cache, self.block_table)

    def mask(self, seq_len, pos, window):
        return _vector_mask(seq_len, pos, window)

    def span_mask(self, seq_len, pos, q_len, window):
        return _span_mask(seq_len, pos, q_len, window)


# ---------------------------------------------------------------------------------
# the host-side pool
# ---------------------------------------------------------------------------------

class PagedKVCache:
    """Page pool + block tables + free list for one ServingEngine.

    ``init_cache_fn(batch, max_len)`` is the model's cache constructor; its
    leaf layout (L, B, S, *rest) is reinterpreted as per-page (L, P, ps, *rest)
    pools, so the same class serves f32/bf16 and int8 (value + scale leaves)
    caches without knowing the schema.  The pools live on the device the
    constructor allocates on; tables and the free list live on the host.
    """

    def __init__(self, init_cache_fn, *, max_batch: int, max_len: int,
                 page_size: int = 16, num_pages: int | None = None):
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(f"page_size={page_size} must be a power of two")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} not a multiple of "
                             f"page_size={page_size}")
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        # worst case: every slot full, plus the trash page
        self.num_pages = (num_pages if num_pages is not None
                          else max_batch * self.pages_per_slot + 1)
        proto = init_cache_fn(1, page_size)
        self.pages = {
            name: torch.zeros((s.shape[0], self.num_pages) + tuple(s.shape[2:]),
                              dtype=s.dtype, device=s.device)
            for name, s in proto.items()}
        self.block_table = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.held = np.zeros(max_batch, np.int32)         # pages owned per slot
        self.worst = np.zeros(max_batch, np.int32)        # reserved worst case
        self._free: list[int] = list(range(self.num_pages - 1, TRASH_PAGE, -1))
        self._outstanding = 0                             # sum(worst - held)

    # -- accounting -------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return max(math.ceil(n_tokens / self.page_size), 1)

    def can_admit(self, total_tokens: int, planned: int = 0) -> bool:
        """True if the pool can guarantee a request writing ``total_tokens``
        logical positions will never starve (``planned``: worst-case pages
        already promised to co-admitted requests)."""
        return (self.pages_needed(total_tokens)
                <= self.n_free - self._outstanding - planned)

    # -- lifecycle --------------------------------------------------------------
    def alloc_prefill(self, slot: int, prompt_len: int, total_tokens: int,
                      n_chunks: int) -> np.ndarray:
        """Allocate the prompt's pages for ``slot`` and reserve its worst
        case.  Returns the (n_chunks,) int32 page-id vector for the bucketed
        prefill scatter -- real pages first, trash for the bucket overhang."""
        n = self.pages_needed(prompt_len)
        worst = max(self.pages_needed(total_tokens), n)
        if n > self.n_free:
            raise RuntimeError("page pool exhausted despite reservation")
        ids = [self._free.pop() for _ in range(n)]
        self.block_table[slot, :n] = ids
        self.held[slot] = n
        self.worst[slot] = worst
        self._outstanding += worst - n
        out = np.full(n_chunks, TRASH_PAGE, np.int32)
        out[:n] = ids
        return out

    def reserve(self, slot: int, total_tokens: int) -> None:
        """Register ``slot``'s worst-case page count without allocating yet
        (chunked admission: pages are appended by ensure_writable_span)."""
        worst = self.pages_needed(total_tokens)
        if worst > self.pages_per_slot:
            raise RuntimeError(f"reservation past slot capacity at slot {slot}")
        self._outstanding += worst - int(self.worst[slot])
        self.worst[slot] = worst

    def ensure_writable(self, slot: int, pos: int) -> None:
        """Append a page if the next write at logical ``pos`` crosses into
        an unallocated page (decode-time growth)."""
        self.ensure_writable_span(slot, pos, 1)

    def ensure_writable_span(self, slot: int, pos: int, n: int) -> None:
        """Make logical positions [pos, pos + n) of ``slot`` writable,
        appending pages as needed, so the multi-step device loop never has
        to sync back for a page append."""
        if n <= 0:
            return
        last_page = (pos + n - 1) // self.page_size
        if last_page >= self.pages_per_slot:
            raise RuntimeError(f"span past slot capacity at slot {slot}")
        if self.held[slot] < pos // self.page_size:
            raise RuntimeError(f"non-contiguous page growth at slot {slot}")
        while self.held[slot] <= last_page:
            if not self._free:
                raise RuntimeError("page pool exhausted despite reservation")
            self.block_table[slot, self.held[slot]] = self._free.pop()
            self.held[slot] += 1
            self._outstanding -= 1

    def shrink_to(self, slot: int, n_tokens: int) -> int:
        """Return pages past ``ceil(n_tokens / ps)`` to the free list
        (speculative-decode rollback); their table entries reset to TRASH
        and re-enter the slot's outstanding reservation.  Returns the number
        of pages freed."""
        keep = min(self.pages_needed(n_tokens), int(self.held[slot]))
        freed = int(self.held[slot]) - keep
        if freed <= 0:
            return 0
        for i in range(keep, int(self.held[slot])):
            self._free.append(int(self.block_table[slot, i]))
            self.block_table[slot, i] = TRASH_PAGE
        self.held[slot] = keep
        self._outstanding += freed
        return freed

    def release(self, slot: int) -> None:
        """Return every page ``slot`` holds and drop its reservation."""
        n = int(self.held[slot])
        if n:
            self._free.extend(int(p) for p in self.block_table[slot, :n])
        self._outstanding -= int(self.worst[slot]) - n
        self.block_table[slot] = TRASH_PAGE
        self.held[slot] = 0
        self.worst[slot] = 0

    # -- migration (drain path; see engine.export_request) ----------------------
    def export_slot(self, slot: int):
        """Copy ``slot``'s held pages out of the pool to the host, in logical
        order: {name: (L, h, ps, *rest)} CPU tensors with h = pages held.
        Positions past the slot's committed count inside the last page are
        garbage, as on the source after a ``shrink_to``; the importer
        rewrites them before any mask lets them be read.  Returns None for a
        slot with no pages yet."""
        h = int(self.held[slot])
        if h == 0:
            return None
        ids = torch.from_numpy(self.block_table[slot, :h].astype(np.int64))
        return {name: pg[:, ids.to(pg.device)].cpu() for name, pg in self.pages.items()}

    def import_slot(self, slot: int, chunks: dict, total_tokens: int) -> None:
        """Install chunks from :meth:`export_slot` as ``slot``'s committed
        KV: allocate exactly their page count, put the slot's worst-case
        reservation (``total_tokens``) on the books, and scatter the pages
        into the pool in logical order."""
        h = next(iter(chunks.values())).shape[1]
        ids = self.alloc_prefill(slot, h * self.page_size, total_tokens, h)
        cache = {name: c.reshape((c.shape[0], 1, h * self.page_size) + tuple(c.shape[3:]))
                 .to(self.pages[name].device) for name, c in chunks.items()}
        write_prefill_pages(self.pages, cache, torch.from_numpy(ids))

    # -- invariants -------------------------------------------------------------
    def check_invariants(self) -> None:
        """Raise AssertionError if page ownership or accounting is broken."""
        owned = [int(p) for s in range(self.block_table.shape[0])
                 for p in self.block_table[s, :self.held[s]]]
        checks = [
            (TRASH_PAGE not in owned, "trash page allocated to a slot"),
            (len(owned) == len(set(owned)), "page owned by two slots"),
            (len(owned) + self.n_free == self.num_pages - 1, "page leak"),
            (self._outstanding == int((self.worst - self.held).sum()),
             "outstanding reservation out of sync"),
            (TRASH_PAGE not in self._free, "trash page on the free list"),
        ]
        for ok, msg in checks:
            if not ok:
                raise AssertionError(msg)


__all__ = ["TRASH_PAGE", "paged_update", "paged_update_span", "paged_gather",
           "write_prefill_pages", "DenseScalarOps", "DenseVectorOps", "PagedOps",
           "PagedKVCache"]
