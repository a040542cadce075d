"""Paged KV cache: block-table storage + the cache ops the mixed step runs on.

Counterpart of ``repro.serving.kvcache`` (see its docstring for the pool's
free-list discipline).  The serving engine's KV memory is a pool of
fixed-size *pages* (``page_size`` tokens each), shared by every slot.
``block_table[s, i]`` is the physical page holding logical positions
``[i*ps, (i+1)*ps)`` of slot ``s``.  Page 0 is the reserved TRASH page: it
is never allocated and absorbs the writes of dead rows.

Where the JAX code rebuilt the pool functionally (``.at[].set``), the port
writes pages in place with ``index_copy_``: the pool is the largest tensor
of a serving replica, and a copy per layer per step would double it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

TRASH_PAGE = 0


# ---------------------------------------------------------------------------------
# device-side page ops
# ---------------------------------------------------------------------------------

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
    after it has parked, when its KV is never read again.  Returns ``cache``.
    """
    P, ps = cache.shape[0], cache.shape[1]
    rest = cache.shape[2:]
    B, T = new.shape[0], new.shape[1]
    n = block_table.shape[1]
    span = torch.arange(T, device=pos.device)
    p = (pos.long()[:, None] + span[None, :]).clamp(0, n * ps - 1)   # (B, T)
    pages = torch.gather(block_table.long(), 1, p // ps)              # (B, T)
    idx = pages * ps + p % ps
    flat = cache.view((P * ps,) + rest)
    flat.index_copy_(0, idx.reshape(-1),
                     new.reshape((B * T,) + rest).to(cache.dtype))
    return cache


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
class PagedOps:
    """Block-table paged cache: pool leaves are (P, ps, *rest), shared by all
    rows; logical order is recovered by gathering in table order."""

    block_table: torch.Tensor                                          # (B, n)

    def write_span(self, cache, new, pos):
        return paged_update_span(cache, new, self.block_table, pos)

    def view(self, cache):
        return paged_gather(cache, self.block_table)

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
    def reserve(self, slot: int, total_tokens: int) -> None:
        """Register ``slot``'s worst-case page count without allocating yet
        (chunked admission: pages are appended by ensure_writable_span)."""
        worst = self.pages_needed(total_tokens)
        if worst > self.pages_per_slot:
            raise RuntimeError(f"reservation past slot capacity at slot {slot}")
        self._outstanding += worst - int(self.worst[slot])
        self.worst[slot] = worst

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


__all__ = ["TRASH_PAGE", "paged_update_span", "paged_gather", "PagedOps",
           "PagedKVCache"]
