"""The output check on the CPU at small sizes: the plain reference against
``repro_torch``'s own forward, whole runs of the harness that come out
correct, the float8 control that does not, and runs with the timed path
broken underneath (the KV pool never written, half of the batch's rows
left out of the attention, a token or a log-probability altered where it
is produced, the second-best token served with its own log-probability,
drafts accepted unverified) that do not either.  Each small cell compares
the numbers that its full cell compares (``bench._small``)."""
import dataclasses

import numpy as np
import pytest
import torch

from bench import check, control, reference, run
from bench._small import DENSE_LIMITS, small_cell
from bench.weights import make_params

SEED = 2**31 + 12345
CELLS = ["qwen2.5-3b.chat-long", "qwen2.5-3b.offline-batch", "olmoe-1b-7b.offline-batch"]


def _run(name, seconds=2.0, seed=SEED, **kw):
    return run.run_cell(small_cell(name, **kw), seed, seconds, False, device="cpu")


@pytest.mark.parametrize("name", ["qwen2.5-3b.chat-long", "olmoe-1b-7b.offline-batch"])
def test_reference_equals_the_port_forward_at_float32(name):
    from bench.spec import model_config
    from repro_torch.models import lm
    cell = small_cell(name, dtype="float32")
    cfg = model_config(cell.config)
    params = make_params(cfg, 7, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    want, _ = lm.forward(params, {"tokens": toks}, cfg, use_kernel=False)
    rows = torch.arange(24)
    got = reference.logits(params, reference.RefModel.of(cell.config), list(toks),
                           [rows, rows])
    for b in range(2):
        torch.testing.assert_close(got[b], want[b].float(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["sample"]["tokens"] >= 20
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(small_cell(name).workload["limits"])
    assert set(res["sample"]["readings"]) == set(check.NAMES)
    want = {m.name for m in small_cell(name).end_to_end}
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_fails_and_the_program_does_not(name):
    """The program against its float8 control, three seeds, the same
    prompts and served tokens, judged as ``bench.control`` judges them:
    by the cell's own numbers."""
    cell = small_cell(name)
    for seed in (1, 2, 3):
        res = run.run_cell(cell, seed, 2.0, False, device="cpu", control=True)
        v = control.verdict(res, cell.workload["limits"])
        assert v["sound"] and v["correct"] and not v["control_correct"], (
            res["checks"], res["control"])


def test_a_control_that_passes_is_reported():
    res = {"correct": True, "control": {"score_err_mean": 0.01}}
    assert control.verdict(res, {"score_err_mean": 0.05}) == {
        "correct": True, "control_correct": True,
        "control_checks": {"score_err_mean": {"value": 0.01, "limit": 0.05}},
        "sound": False}
    assert not control.verdict({"correct": False}, {})["sound"]
    assert control.verdict({"correct": True, "control": None}, {})["sound"]


def _broken_kv(monkeypatch):
    from repro_torch.serving import kvcache
    monkeypatch.setattr(kvcache.PagedOps, "write_span", lambda self, cache, new, pos: cache)


def _altered(monkeypatch, what):
    from repro_torch.models import lm
    real = lm.fused_lmhead_greedy

    def wrong(h, w):
        tok, lp = real(h, w)
        if what == "token":
            return (tok + 1) % w.shape[1], lp
        if what == "second":
            lps = torch.log_softmax(h.float() @ w.float(), dim=-1)
            second = lps.topk(2, dim=-1).indices[..., 1]
            return second.to(tok.dtype), lps.gather(-1, second[..., None])[..., 0]
        return tok, lp - 0.05
    monkeypatch.setattr(lm, "fused_lmhead_greedy", wrong)


def _drafts_unverified(monkeypatch):
    """Every draft token is accepted, whatever the verifier said after the
    position before it."""
    from repro_torch.serving import engine
    monkeypatch.setattr(engine, "prefix_len",
                        lambda match: torch.full(match.shape[:-1], match.shape[-1],
                                                 dtype=torch.long, device=match.device))


def _half_the_rows(monkeypatch):
    """The mixed attention leaves every second row of the batch out: its
    output is zeros there, the other rows are served as before."""
    from repro_torch.models import lm
    real = lm.decode_attention_mixed

    def half(q, *a, **kw):
        out = real(q, *a, **kw).clone()
        out[1::2] = 0
        return out
    monkeypatch.setattr(lm, "decode_attention_mixed", half)


@pytest.mark.parametrize("name", ["qwen2.5-3b.offline-batch", "olmoe-1b-7b.offline-batch"])
def test_half_the_rows_left_out_is_not_correct(name, monkeypatch):
    """A backlog fills every slot, so half of the sampled requests sat in a
    row whose attention the step dropped."""
    _half_the_rows(monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]


FAULTS = {"kv_never_written": _broken_kv,
          "token_altered": lambda mp: _altered(mp, "token"),
          "logprob_altered": lambda mp: _altered(mp, "logprob"),
          "argmax_slip": lambda mp: _altered(mp, "second"),
          "drafts_unverified": _drafts_unverified}


# the MoE cell compares its tokens only (PERF.md §2): a log-probability
# altered alone is the dense cells' to catch, through the same epilogue
CASES = [(n, f) for n in CELLS for f in sorted(FAULTS)
         if not (n == "olmoe-1b-7b.offline-batch" and f == "logprob_altered")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]


def test_sample_takes_the_longest_first_and_enough_tokens():
    R = dataclasses.make_dataclass("R", ["prompt", "output"])
    done = [R(np.zeros(n), [1] * m) for n, m in [(5, 3), (50, 10), (7, 4), (6, 8), (9, 2)]]
    picked = check.sample(done, 3, 12)
    assert picked[0] is done[1]
    assert sum(len(r.output) for r in picked) >= 12
    assert check.sample(done, 3, 12) == picked
    assert check.sample([], 3, 12) == []


def test_judge_needs_every_number_it_names():
    ok, checks = check.judge({"token_gap_max": 0.0}, DENSE_LIMITS)
    assert not ok and checks["score_err_max"]["value"] is None
    assert check.judge({"token_gap_max": 0.0, "score_err_max": 0.0,
                        "token_gap_mean": 9.0}, DENSE_LIMITS)[0]
    assert list(checks) == list(DENSE_LIMITS)
