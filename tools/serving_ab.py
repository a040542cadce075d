"""Time one checkout's serving paths end to end on the card: phase 5's 16
requests (``chip_smoke.main_requests``) drained through ``ServingEngine``
on the chunked path (phase 5) and the bucketed path (phase 5b), at bf16
with seeded random weights and ``ServeConfig(max_batch=8, max_len=1024)``.

    python3 tools/serving_ab.py [--tree DIR] [--label NAME] [--arch NAME]
                                [--reps N] [--paths chunked,bucketed]

``--tree`` is the root of a checkout of this repository (default: the one
this script lives in).  Its ``src/repro_torch`` is imported and its kernels
are built into its own ``build/``, so two commits compare on one card by
running the script once per tree on one machine, in the order A, B, B, A.
Each path is drained once to warm up, then ``--reps`` times; each drain is
timed on the host clock between two synchronisations of the card, and
every request must complete with the pages conserved.  The tokens of each
drain are hashed, so two trees that must agree can be compared.  One line
per drain, then, as the last line, one JSON object of every time.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path
from statistics import median

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (this checkout's request set and helpers)


def drain(model, params, dev, *, chunked: bool) -> dict:
    """One drain of phase 5's requests: wall seconds, engine steps, emitted
    tokens and a hash of every request's tokens."""
    import torch
    from repro_torch.serving import ServeConfig, ServingEngine

    eng = ServingEngine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                                   chunked_prefill=chunked), device=dev)
    reqs = chip_smoke.main_requests(model.cfg.vocab)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.kv.check_invariants()
    if not (len(eng.completed) == len(reqs) and eng.kv.n_free == eng.kv.num_pages - 1):
        raise AssertionError("a drain left requests incomplete or pages held")
    tokens = json.dumps([[int(t) for t in r.output] for r in reqs])
    return {"wall_s": wall, "steps": eng.step_count,
            "emitted": sum(len(r.output) for r in reqs),
            "tokens_sha1": hashlib.sha1(tokens.encode()).hexdigest()[:12]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--paths", default="chunked,bucketed")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE / "src"]
    sys.path.insert(0, str(tree / "src"))

    import torch
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA card", file=sys.stderr)
        return 1
    import repro_torch
    if tree not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    log = chip_smoke.log
    card = chip_smoke.card_line()
    label = args.label or tree.name
    log(f"[serving ab] {label}: {tree}; {card}; torch {torch.__version__}")
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_model(get_config(args.arch))                  # on the GPU
    params = model.init_params(chip_smoke.SEED)
    result = {"label": label, "card": card, "arch": args.arch}
    for path in args.paths.split(","):
        chunked = {"chunked": True, "bucketed": False}[path]
        drain(model, params, dev, chunked=chunked)               # warm-up
        runs = [drain(model, params, dev, chunked=chunked) for _ in range(args.reps)]
        for i, r in enumerate(runs):
            log(f"[serving ab] {label} {args.arch} {path} drain {i}: {r['wall_s']:.3f} s, "
                f"{r['steps']} steps of {1e3 * r['wall_s'] / r['steps']:.2f} ms, "
                f"{r['emitted'] / r['wall_s']:.1f} emitted tok/s, tokens {r['tokens_sha1']}")
        result[path] = {"wall_s": [r["wall_s"] for r in runs],
                        "ms_per_step": median(1e3 * r["wall_s"] / r["steps"] for r in runs),
                        "steps": runs[0]["steps"], "tokens_sha1": runs[0]["tokens_sha1"]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
