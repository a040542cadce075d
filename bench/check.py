"""How ``correct`` is decided: the served tokens of a sample of finished
requests against the plain reference.

The sample is drawn from the seed: the request with the most positions
first, then others at random until ``sample_tokens`` served tokens are in
it.  The reference runs once over each prompt with its served tokens and
gives the float32 logits after each position that produced a served
token.  The numbers read (the cell's workload file names, under
``limits``, those compared, each with its limit):

* ``token_gap_max``: the widest gap by which a served token's logit lies
  below the reference's best logit at its position (0 where the served
  token is the reference's argmax); ``token_gap_mean``: the mean gap over
  the served tokens; ``token_mismatch_pct``: the share of served tokens
  that are not the reference's argmax;
* ``score_err_max``: the largest difference between a request's
  ``Request.score`` (the engine's mean log-probability of its served
  tokens, from the fused lm-head epilogue) and the reference's mean
  log-probability of the same tokens; ``score_err_mean``: the mean of
  those differences over the sampled requests;
* ``greedy_err_max`` / ``greedy_err_mean``: the same, against the
  reference's mean log-probability of its own best token at each served
  position.  A served token that is not the best, reported with its own
  log-probability (an argmax slip, a draft accepted unverified), leaves
  ``score_err`` where it was and moves this by its gap.

The control (``fp8=True``) stands in the program's place: at each position
its first token is read under the reference's logits, its mean
log-probability of the served tokens against the reference's, and its
mean log-probability of its own first tokens against the reference's of
the reference's own.
"""
from __future__ import annotations

import numpy as np
import torch

from bench import reference

NAMES = ("token_gap_max", "token_gap_mean", "token_mismatch_pct", "score_err_max",
         "score_err_mean", "greedy_err_max", "greedy_err_mean")


def sample(done, seed: int, sample_tokens: int):
    """``done``: finished requests (``prompt``, ``output``, ``score``).  The
    longest first, then a seeded random order, until ``sample_tokens``
    served tokens are taken."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + len(done[i].output))
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    out, n = [], 0
    for i in [longest, *rest]:
        out.append(done[i])
        n += len(done[i].output)
        if n >= sample_tokens:
            break
    return out


def _sequences(reqs, device):
    seqs, rows = [], []
    for r in reqs:
        toks = np.concatenate([np.asarray(r.prompt, np.int64), np.asarray(r.output, np.int64)])
        p = len(r.prompt)
        seqs.append(torch.from_numpy(toks[:p + len(r.output) - 1]).to(device))
        rows.append(torch.arange(p - 1, p - 1 + len(r.output), device=device))
    return seqs, rows


def readings(params, conf: dict, reqs, *, control: bool = False) -> dict:
    """The compared numbers of ``reqs`` (served requests): the program's
    (``control=False``), or those of the float8 control on the same
    prompts and tokens."""
    if not reqs:
        return {}
    device = params["embed"].device
    m = reference.RefModel.of(conf)
    seqs, rows = _sequences(reqs, device)
    ref = reference.logits(params, m, seqs, rows)
    low = reference.logits(params, m, seqs, rows, fp8=True) if control else None
    gaps, errs, greedy = [], [], []
    for i, r in enumerate(reqs):
        served = torch.as_tensor(np.asarray(r.output, np.int64), device=device)
        lg = ref[i]
        best = lg.max(dim=-1).values
        pick = low[i].argmax(dim=-1) if control else served
        gaps.append(best - lg.gather(1, pick[:, None])[:, 0])
        ref_lps = torch.log_softmax(lg, dim=-1)
        ref_lp = float(ref_lps.gather(1, served[:, None])[:, 0].mean())
        ref_best = float(ref_lps.max(dim=-1).values.mean())
        if control:
            low_lps = torch.log_softmax(low[i], dim=-1)
            got = float(low_lps.gather(1, served[:, None])[:, 0].mean())
            own = float(low_lps.max(dim=-1).values.mean())
        else:
            got = own = float(r.score)
        errs.append(abs(got - ref_lp))
        greedy.append(abs(own - ref_best))
    gap = torch.cat(gaps)
    return {"token_gap_max": float(gap.max()), "token_gap_mean": float(gap.mean()),
            "token_mismatch_pct": 100.0 * float((gap > 0).float().mean()),
            "score_err_max": max(errs), "score_err_mean": sum(errs) / len(errs),
            "greedy_err_max": max(greedy), "greedy_err_mean": sum(greedy) / len(greedy)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names within its limit,
    {name: {value, limit}})."""
    checks = {n: {"value": values.get(n), "limit": lim} for n, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


__all__ = ["NAMES", "judge", "readings", "sample"]
