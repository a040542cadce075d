"""What one cell is: its entry in ``BENCHMARK.json`` and the data files that
the entry names.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the model's
published sizes, as run), ``traffic/<traffic>.json`` (the mix's shape) and
``workloads/<cell>.json`` (the engine's width, the offered load and the
limits of the output check).  Nothing here names a cell: a new cell is new
data files and a new entry in ``BENCHMARK.json``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: tuple     # Metric, in BENCHMARK.json's order
    per_layer: tuple

    @property
    def loop(self) -> str:
        """``open`` (requests as they come due) or ``offline`` (a backlog)."""
        return "offline" if self.traffic["arrivals"]["kind"] == "backlog" else "open"


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``manifest``) with its
    data files and the metrics it reports; KeyError for an unknown cell."""
    manifest = load_json(ROOT / "BENCHMARK.json") if manifest is None else manifest
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(entries))})")
    w = entries[name]
    e2e = tuple(Metric(m["name"], m["unit"])
                for m in manifest["end_to_end"] if _applies(m, name))
    layer = tuple(Metric(m["name"], m["unit"])
                  for m in manifest["per_layer"] if _applies(m, name))
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]),
                config=load_json(BENCH / "configs" / f"{w['config']}.json"),
                traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                workload=load_json(BENCH / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def model_config(conf: dict):
    """``repro_torch``'s ModelConfig for a configuration file (its published
    keys, with the port's own under ``port``)."""
    import torch
    from repro_torch.models.common import ModelConfig, MoEConfig

    port = conf["port"]
    moe = None
    if port["family"] == "moe":
        moe = MoEConfig(n_experts=conf["num_experts"], top_k=conf["num_experts_per_tok"],
                        d_expert=conf["intermediate_size"],
                        capacity_factor=float(port["capacity_factor"]))
    fields = dict(
        name=conf["model_type"], family=port["family"],
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"], n_kv_heads=conf["num_key_value_heads"],
        d_ff=0 if moe else conf["intermediate_size"], vocab=conf["vocab_size"],
        rope_theta=float(conf["rope_theta"]), qkv_bias=bool(port["qkv_bias"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]), moe=moe,
        dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[conf["torch_dtype"]],
        remat="none")
    return ModelConfig(**fields)


__all__ = ["BENCH", "ROOT", "Cell", "Metric", "load_cell", "load_json", "model_config"]
