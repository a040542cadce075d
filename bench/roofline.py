"""The yardstick: the card's peaks, and the operations and bytes that the
model's step and its two main-path kernels need.

Frozen copies, so that no later change to the program moves them:

* the peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W): 989
  TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s
  HBM;
* the bound rule of ``PERF.md`` section 6 (the kernel table): each input
  byte read once and each output byte written once over 3.35 TB/s,
  operations over 989 TFLOP/s bf16, the larger of the two;
* the work counted from what these inputs need: a paged-attention row
  reads the keys and values of the positions its queries see, not whole
  pages; the lm-head counts its matrix product, not the softmax around it.
"""
from __future__ import annotations

from dataclasses import dataclass

BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12        # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Shape:
    """The sizes the arithmetic needs, read from a configuration file."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    ffn: int               # dense MLP width, or one expert's width
    experts: int           # 0 for a dense model
    top_k: int
    elem: int = 2          # bytes of a weight or activation: 2 bf16, 4 float32

    @property
    def peak(self) -> float:
        return BF16_FLOPS_PER_S if self.elem == 2 else F32_FLOPS_PER_S

    @classmethod
    def of(cls, conf: dict) -> "Shape":
        moe = conf["port"]["family"] == "moe"
        return cls(layers=conf["num_hidden_layers"], d=conf["hidden_size"],
                   heads=conf["num_attention_heads"], kv_heads=conf["num_key_value_heads"],
                   head_dim=conf["hidden_size"] // conf["num_attention_heads"],
                   vocab=conf["vocab_size"], ffn=conf["intermediate_size"],
                   experts=conf["num_experts"] if moe else 0,
                   top_k=conf["num_experts_per_tok"] if moe else 0,
                   elem=2 if conf["torch_dtype"] == "bfloat16" else 4)


def bound_s(s: Shape, flops: float, n_bytes: float) -> float:
    return max(flops / s.peak, n_bytes / HBM_BYTES_PER_S)


def matmul_params(s: Shape) -> int:
    """Weights one position multiplies by: attention projections, the MLP
    (or the router and its top-k experts) in every layer, and the lm-head
    once.  The embedding lookup is no product and is left out."""
    attn = s.d * s.heads * s.head_dim * 2 + 2 * s.d * s.kv_heads * s.head_dim
    ffn = (s.top_k * 3 * s.d * s.ffn + s.d * s.experts) if s.experts else 3 * s.d * s.ffn
    return s.layers * (attn + ffn) + s.d * s.vocab


def positions_flops(s: Shape, first: float, last: float) -> float:
    """Useful operations of the positions ``first + 1 .. last`` of one
    sequence (1-based: position c attends c keys): 2 per weight, and 4 * hd
    per key and query head for the scores and the weighted values."""
    n = last - first
    if n <= 0:
        return 0.0
    keys = (first + 1 + last) * n / 2.0
    return 2.0 * matmul_params(s) * n + 4.0 * s.head_dim * s.heads * s.layers * keys


def paged_attention_cost(s: Shape, starts, T: int, page_size: int) -> tuple[float, float]:
    """One mixed-attention call over rows whose T queries start at
    ``starts``: (operations, bytes).  Row b's query t sees keys
    0 .. starts[b] + t; the row reads starts[b] + T keys and values once,
    and the block-table entries of their pages."""
    flops = 0.0
    kv_tokens = 0.0
    pages = 0.0
    for st in starts:
        flops += 4.0 * s.head_dim * s.heads * (T * st + T * (T + 1) / 2.0)
        kv_tokens += st + T
        pages += -(-(st + T) // page_size)
    q_and_out = 2 * len(starts) * T * s.heads * s.head_dim * s.elem
    kv = 2 * kv_tokens * s.kv_heads * s.head_dim * s.elem
    return flops, q_and_out + kv + 4 * (pages + len(starts))


def lmhead_cost(s: Shape, rows: int) -> tuple[float, float]:
    """One fused lm-head greedy call over ``rows`` hidden states: the (d, V)
    head and the rows read once, a token and a log-probability written."""
    flops = 2.0 * rows * s.d * s.vocab
    n_bytes = (s.d * s.vocab + rows * s.d) * s.elem + rows * 8
    return flops, n_bytes


__all__ = ["BF16_FLOPS_PER_S", "F32_FLOPS_PER_S", "HBM_BYTES_PER_S", "Shape", "bound_s", "lmhead_cost",
           "matmul_params", "paged_attention_cost", "positions_flops"]
