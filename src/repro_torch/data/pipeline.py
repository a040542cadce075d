"""Deterministic sharded data pipeline.

Training: an infinite synthetic token stream (Zipf-distributed ids over a
Markov backbone so losses actually go down) that is *deterministically
resumable*: batch ``i`` depends only on (seed, i), so a restarted job at step
``s`` regenerates exactly the batches it would have seen -- the data-side half
of fault tolerance.  Sharding: each host slices its ``process_index`` rows.

Serving: a bursty request stream whose arrival intensity follows the paper's
match-trace structure (the LLM analogue of the tweet workload).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenStream:
    """Deterministic, seekable synthetic LM data."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # fixed random Markov transition "hubs" make the stream learnable
        rng = np.random.default_rng(cfg.seed)
        self._hub = rng.integers(0, cfg.vocab, size=1024).astype(np.int32)

    def batch(self, index: int) -> dict:
        """Batch ``index`` (global step), host-local slice. {tokens, targets}."""
        cfg = self.cfg
        rows = []
        base = index * cfg.global_batch + self.host_id_offset
        for r in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed, base + r))
            z = rng.zipf(1.4, size=cfg.seq_len).astype(np.int64)
            toks = (z % (cfg.vocab - 2)) + 1
            # splice hub n-grams for learnable structure
            for _ in range(cfg.seq_len // 64):
                p = int(rng.integers(0, cfg.seq_len - 8))
                h = int(rng.integers(0, 1016))
                toks[p : p + 8] = self._hub[h : h + 8]
            rows.append(toks.astype(np.int32))
        tokens = np.stack(rows)
        return {"tokens": tokens, "targets": tokens.copy()}

    @property
    def host_id_offset(self) -> int:
        return self.cfg.host_id * self.local_batch


def request_stream(*, n_requests: int, seed: int = 0, mean_prompt: int = 64,
                   mean_decode: int = 32, burst_times=(), burst_scale: float = 4.0,
                   horizon_s: float = 600.0):
    """Bursty serving workload: Poisson base + multiplicative bursts
    (the paper's Fig-4 structure mapped onto LLM requests).

    Yields (arrival_s, prompt_len, decode_len) sorted by arrival.
    """
    rng = np.random.default_rng(seed)
    n_sec = int(horizon_s)
    lam = np.ones(n_sec) * (n_requests / n_sec)
    t = np.arange(n_sec, dtype=np.float64)
    for b in burst_times:
        prof = np.where(t < b, np.exp(-((t - b) ** 2) / (2 * 20.0 ** 2)),
                        np.exp(-(t - b) / 60.0))
        lam = lam * (1.0 + (burst_scale - 1.0) * prof)
    lam *= n_requests / lam.sum()
    counts = rng.poisson(lam)
    out = []
    for sec, c in enumerate(counts):
        for _ in range(c):
            out.append((
                sec + rng.random(),
                max(int(rng.exponential(mean_prompt)), 4),
                max(int(rng.exponential(mean_decode)), 1),
            ))
    out.sort()
    return out


__all__ = ["DataConfig", "TokenStream", "request_stream"]
