"""Speculative multi-token decode: draft proposers + the acceptance rule.

Counterpart of ``repro.serving.speculate`` (see its docstring for the
verify-block scheme).  Proposers are functions on device tensors
``(hist, ell) -> (B, d)``:

* ``hist``: (B, H) committed token history (prompt + emitted), garbage past
  ``ell``;
* ``ell``: (B,) valid history lengths;
* returns ``d`` draft tokens per row, to be placed after ``hist[ell-1]``.

A wrong draft is never incorrect output -- it only wastes verifier work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import torch


class Proposer(Protocol):
    """Draft proposer protocol: drafts ``draft_len`` tokens per row from the
    committed history."""

    draft_len: int

    def __call__(self, hist: torch.Tensor, ell: torch.Tensor) -> torch.Tensor: ...


# replint-torch: traced -- called from the serving engine's mixed step
def prefix_len(match: torch.Tensor) -> torch.Tensor:
    """Length of the leading all-True run along the last axis: the number of
    block positions committed by the acceptance rule."""
    return torch.cumprod(match.long(), dim=-1).sum(dim=-1)


def _take(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(hist, clip(idx, 0, H-1), axis=1)`` with ``idx``
    broadcast to hist's batch."""
    H = hist.shape[1]
    idx = idx.clamp(0, H - 1).expand(hist.shape[0], -1)
    return torch.gather(hist, 1, idx)


@dataclass(frozen=True)
class NGramProposer:
    """Prompt-lookup decoding: find the latest earlier occurrence of the
    trailing ``ngram`` committed tokens and propose what followed it; repeat
    the last committed token where no match exists or the matched
    continuation runs past known history."""

    draft_len: int
    ngram: int = 2

    # replint-torch: traced -- called from the serving engine's mixed step
    def __call__(self, hist: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
        B, H = hist.shape
        i = torch.arange(H, device=hist.device)[None, :]          # candidate end
        ell = ell.long()
        last_i = (ell - 1)[:, None]                               # (B, 1)
        last = _take(hist, last_i)                                # (B, 1)
        match = torch.ones((B, H), dtype=torch.bool, device=hist.device)
        for j in range(self.ngram):
            a = _take(hist, i - j)
            b = _take(hist, last_i - j)
            match &= (a == b) & (i - j >= 0)
        # the end of the candidate n-gram must precede the trailing one, and
        # a continuation token must exist: i + 1 <= ell - 1
        valid = (i >= self.ngram - 1) & (i <= ell[:, None] - 2)
        m = torch.where(match & valid, i, -1).amax(dim=1)         # (B,), -1 = none
        steps = torch.arange(self.draft_len, device=hist.device)
        cont = m[:, None] + 1 + steps[None, :]
        known = (m[:, None] >= 0) & (cont < ell[:, None])
        return torch.where(known, _take(hist, cont), last)


@dataclass(frozen=True)
class RepeatProposer:
    """Degenerate proposer: repeat the last committed token."""

    draft_len: int

    # replint-torch: traced -- called from the serving engine's mixed step
    def __call__(self, hist: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
        last = _take(hist, (ell.long() - 1)[:, None])             # (B, 1)
        return last.expand(hist.shape[0], self.draft_len)


def make_proposer(kind: str, draft_len: int, *, ngram: int = 2) -> Proposer:
    """Proposer registry for config-string construction."""
    if kind == "ngram":
        return NGramProposer(draft_len=draft_len, ngram=ngram)
    if kind == "repeat":
        return RepeatProposer(draft_len=draft_len)
    raise ValueError(f"unknown proposer kind: {kind!r}")


__all__ = ["Proposer", "prefix_len", "NGramProposer", "RepeatProposer",
           "make_proposer"]
