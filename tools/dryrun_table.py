"""The dry run's records as one markdown table: a row per arch, a column per
shape, each cell the single-pod (16x16) and two-pod (2x16x16) records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    python3 tools/dryrun_table.py [results/dryrun_torch.jsonl]

A cell reads ``argument / peak`` GB a rank at 16x16, then ``;`` and the
same at 2x16x16; a pair in bold does not fit one 80 GB card (``fits``
false).  Under the table: the skipped cells with their reason, the
dominant roofline terms counted, and the records' wall seconds summed.
Reads the newest record of each cell.
"""
from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path


def _pair(r: dict | None) -> str:
    if r is None:
        return "not run"
    if r["status"] != "ok":
        return r["status"]
    m = r["memory"]
    peak = "n/a" if m["peak_bytes"] is None else f"{m['peak_bytes'] / 1e9:.2f}"
    text = f"{m['argument_bytes'] / 1e9:.2f} / {peak}"
    return text if r["fits"] else f"**{text}**"


def main() -> int:
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch.jsonl")
    recs = {}
    for line in path.read_text().splitlines():
        r = json.loads(line)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    archs = list(dict.fromkeys(a for a, _, _ in recs))
    shapes = list(dict.fromkeys(s for _, s, _ in recs))
    print("| arch | " + " | ".join(shapes) + " |")
    print("| --- |" + " --- |" * len(shapes))
    skipped = {}
    for a in archs:
        cells = []
        for s in shapes:
            single, multi = recs.get((a, s, "single")), recs.get((a, s, "multi"))
            if any(r is not None and r["status"] == "skipped" for r in (single, multi)):
                skipped.setdefault((s, (single or multi)["reason"]), []).append(a)
                cells.append("skipped")
            else:
                cells.append(f"{_pair(single)}; {_pair(multi)}")
        print(f"| {a} | " + " | ".join(cells) + " |")
    for (s, why), names in skipped.items():
        print(f"\nSkipped, {s} ({why}): {', '.join(names)}.")
    ok = [r for r in recs.values() if r["status"] == "ok"]
    dominant = Counter(r["roofline"]["dominant"] for r in ok)
    wall = sum(r.get("wall_s", 0.0) for r in recs.values())
    print(f"\n{len(recs)} records: {len(ok)} ok ({sum(r['fits'] for r in ok)} fit), "
          f"{sum(r['status'] == 'skipped' for r in recs.values())} skipped, "
          f"{sum(r['status'] == 'error' for r in recs.values())} errors; dominant term "
          f"{dict(dominant)}; wall {wall:.1f} s summed over the records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
