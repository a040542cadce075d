"""Cells shrunk to a size the CPU tests can run: the same data files with
the widths, the engine and the traffic cut down, so that the harness's
whole path (traffic, driver, readers, output check) runs here on the
port's plain versions."""
from __future__ import annotations

import dataclasses

from bench.spec import load_cell

DENSE = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
         "num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 256}
MOE = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
       "num_hidden_layers": 2, "intermediate_size": 32, "vocab_size": 256,
       "num_experts": 8, "num_experts_per_tok": 2}
# what these sizes read (bench/test_bench_check.py): the bf16 dense cell's
# program at most 0.0008 / 0.0017, the float8 control at least 0.034 / 0.0077
DENSE_LIMITS = {"token_gap_max": 0.01, "score_err_max": 0.004}
# the small MoE cells run at float32: at d 64 with 8 experts a bf16
# rounding flips a top-2 choice often enough to move a logit by 2; at
# float32 the port is the reference to 2e-4, so every number gets 1e-3
F32_LIMIT = 1e-3


def small_cell(name: str, *, dtype: str | None = None):
    """The cell ``name`` at the CPU tests' size; MoE cells at float32
    unless ``dtype`` says otherwise.  Its output check compares the numbers
    that the full cell compares, with limits for this size."""
    cell = load_cell(name)
    moe = cell.config["port"]["family"] == "moe"
    conf = dict(cell.config, **(MOE if moe else DENSE))
    if moe:
        conf["port"] = dict(conf["port"], capacity_factor=4.0)   # E / k: dropless
    conf["torch_dtype"] = dtype or ("float32" if moe else "bfloat16")
    # the full cell's own numbers, each with a limit for this size
    own = cell.workload["limits"]
    if conf["torch_dtype"] == "float32":
        limits = {n: F32_LIMIT for n in own}
    else:
        limits = {n: DENSE_LIMITS[n] for n in own}
    tr = dict(cell.traffic,
              prompt=dict(cell.traffic["prompt"], median=40, min=8, max=60),
              output=dict(cell.traffic["output"], median=8, min=4, max=12),
              prefix_tokens=min(int(cell.traffic.get("prefix_tokens", 0)), 8))
    wl = dict(cell.workload, max_batch=4, max_len=128, sample_tokens=40, drain_s=30.0,
              limits=limits)
    if "rate_per_s" in wl:
        wl["rate_per_s"] = 2.0
    if "backlog_per_s" in wl:
        wl["backlog_per_s"] = 4.0
    return dataclasses.replace(cell, config=conf, traffic=tr, workload=wl)


__all__ = ["DENSE_LIMITS", "F32_LIMIT", "small_cell"]
