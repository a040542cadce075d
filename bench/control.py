"""The readings that the output check's limits are set from, on the card.

    python3 -m bench.control --workload <cell> --seconds <s> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--weights-seed <n>] [--metrics tpot_p95_ms]

One process runs the cell's window once per seed, at the cell's own sizes
and load, and prints one JSON line per seed: the program's compared
numbers (``checks``, with every reading under ``sample``) and, for the
seeds in ``--control-seeds``, the float8 control's on the same sample
(``control``), judged by the cell's own limits (``control_correct``).  The
limit of each number lies above the largest program reading and below the
smallest control reading (``PERF.md`` gives both).  It exits 1 where a
program run is not correct or a control run is.

``--weights-seed`` draws every run's weights from that one seed, the
traffic still from each seed, and ``--metrics`` reads end-to-end metrics
that the cell does not report (``"metrics"``): together they tell what
part of a run's work moves a metric from seed to seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from bench.run import ROOT


def verdict(res: dict, limits: dict) -> dict:
    """What a run of ``bench.control`` says of one seed: the program's run
    correct, and the float8 control's readings (where the run has them)
    judged by the cell's limits, which they have to fail."""
    from bench import check
    out = {"correct": res["correct"]}
    if res.get("control") is not None:
        out["control_correct"], out["control_checks"] = check.judge(res["control"], limits)
    out["sound"] = out["correct"] and not out.get("control_correct", False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--weights-seed", type=int, default=None)
    ap.add_argument("--metrics", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench.run import run_cell
    from bench.spec import Metric, load_cell, load_json
    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    units = {m["name"]: m["unit"] for m in load_json(ROOT / "BENCHMARK.json")["end_to_end"]}
    extra = tuple(Metric(n, units[n]) for n in args.metrics.split(",")
                  if n and n not in {m.name for m in cell.end_to_end})
    cell = dataclasses.replace(cell, end_to_end=cell.end_to_end + extra)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    sound = True
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, control=seed in ctrl,
                       weights_seed=args.weights_seed)
        v = verdict(res, cell.workload["limits"])
        sound = sound and v["sound"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "weights_seed": args.weights_seed, **v,
                          "failed": res["failed"], "metrics": res["metrics"],
                          "sample": res["sample"], "checks": res["checks"],
                          "control": res.get("control")}), flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
