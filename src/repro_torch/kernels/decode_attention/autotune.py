"""Per-device defaults of the mixed serving step, keyed by ``device.type``.

Counterpart of the ``DEFAULTS`` table of
``repro.kernels.decode_attention.autotune`` (the sweeps themselves are not
ported yet).  ``page_size`` is the KV page, ``chunk_size`` the prefill tokens
folded into one mixed step per row, ``draft_len`` the speculative tokens
proposed per row per step, ``lmhead_block_v`` the vocab tile of a streamed
lm-head epilogue (0 = one fused product, what the plain version does).

* ``"cpu"`` is the JAX package's ``"cpu"`` row, so the CPU parity tests run
  the reference's shapes.
* ``"cuda"`` starts from the same page, chunk and draft values and is not
  yet swept on the card; its ``lmhead_block_v`` is the CUDA kernel's vocab
  tile (``kTileV`` in ``csrc/lmhead_greedy.cu``).
"""
from __future__ import annotations

DEFAULTS = {
    "cpu": {"page_size": 16, "chunk_size": 16, "draft_len": 3,
            "lmhead_block_v": 0},
    # not yet swept on the card
    "cuda": {"page_size": 16, "chunk_size": 16, "draft_len": 3,
             "lmhead_block_v": 64},
}


def _row(device_type: str) -> dict:
    return DEFAULTS.get(device_type, DEFAULTS["cpu"])


def default_page_size(device_type: str = "cpu") -> int:
    return _row(device_type)["page_size"]


def default_chunk_size(device_type: str = "cpu") -> int:
    return _row(device_type)["chunk_size"]


def default_draft_len(device_type: str = "cpu") -> int:
    return _row(device_type)["draft_len"]


def default_lmhead_block_v(device_type: str = "cpu") -> int:
    return _row(device_type)["lmhead_block_v"]


__all__ = ["DEFAULTS", "default_page_size", "default_chunk_size",
           "default_draft_len", "default_lmhead_block_v"]
