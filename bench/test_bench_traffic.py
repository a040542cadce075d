"""The traffic generator: deterministic per seed, the mixes' lengths and
rates, the same work for every seed."""
import dataclasses

import numpy as np
import pytest

from bench import traffic
from bench.spec import BENCH, load_cell, load_json

# the tweet mix has no cell (PERF.md §7); it is generated here at the rate
# and length that its cell ran
TWEETS = "olmoe-1b-7b+tweet-burst"
CELLS = ["qwen2.5-3b.chat-long", TWEETS, "qwen2.5-3b.offline-batch"]


def _cell(name):
    if name != TWEETS:
        return load_cell(name)
    cell = load_cell("olmoe-1b-7b.offline-batch")
    return dataclasses.replace(
        cell, traffic=load_json(BENCH / "traffic" / "tweet-burst.json"),
        workload={"max_batch": 64, "max_len": 512, "rate_per_s": 12.0})


def _gen(name, seed, seconds=30.0):
    cell = _cell(name)
    vocab = cell.config["vocab_size"]
    return cell, traffic.generate(cell.traffic, cell.workload, vocab, seed, seconds)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_requests(name):
    _, a = _gen(name, 2**31 + 7)
    _, b = _gen(name, 2**31 + 7)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.due_s == y.due_s and x.max_new_tokens == y.max_new_tokens
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", CELLS)
def test_seeds_share_sizes_and_gaps_in_another_order(name):
    _, a = _gen(name, 11)
    _, b = _gen(name, 12)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) == sorted(r.max_new_tokens for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


@pytest.mark.parametrize("name", CELLS)
def test_lengths_within_the_mix(name):
    cell, reqs = _gen(name, 5)
    tr = cell.traffic
    pre = tr.get("prefix_tokens", 0)
    plen = np.array([len(r.prompt) - pre for r in reqs])
    olen = np.array([r.max_new_tokens for r in reqs])
    assert plen.min() >= tr["prompt"]["min"] and plen.max() <= tr["prompt"]["max"]
    assert olen.min() >= tr["output"]["min"] and olen.max() <= tr["output"]["max"]
    vocab = cell.config["vocab_size"]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < vocab for r in reqs)
    assert max(len(r.prompt) + r.max_new_tokens for r in reqs) <= cell.workload["max_len"]
    if tr["prompt"]["kind"] == "lognormal":
        assert abs(np.median(plen) - tr["prompt"]["median"]) <= 0.05 * tr["prompt"]["median"]


def test_poisson_rate_and_gaps():
    cell = load_cell("qwen2.5-3b.chat-long")
    wl = dict(cell.workload, rate_per_s=8.0)
    reqs = traffic.generate(cell.traffic, wl, 1000, 3, 40.0)
    due = np.array([r.due_s for r in reqs])
    assert len(reqs) == 320
    assert due.min() == 0.0 and due.max() < 40.0 and np.all(np.diff(due) >= 0)
    gaps = np.diff(due)
    assert abs(gaps.mean() - 1 / 8.0) < 0.01
    # exponential gaps: the standard deviation is the mean
    assert 0.8 < gaps.std() / gaps.mean() < 1.2


def test_burst_peaks_at_onset():
    cell = _cell(TWEETS)
    arr = cell.traffic["arrivals"]
    wl = dict(cell.workload, rate_per_s=10.0)
    due = np.array([r.due_s for r in traffic.generate(cell.traffic, wl, 1000, 4, 30.0)])
    on = arr["onset_s"]
    t = np.linspace(0.0, 4.0, 401)
    expect = 10.0 * traffic.burst_profile(t, on, arr["scale"], arr["rise_s"],
                                          arr["decay_s"]).mean()
    early = np.sum(due < 4.0) / 4.0
    peak = np.sum((due >= on - 1.0) & (due < on + 1.0)) / 2.0
    assert 0.8 * expect < early < 1.2 * expect
    assert 0.8 * arr["scale"] * 10.0 < peak < 1.2 * arr["scale"] * 10.0
    assert peak > 1.5 * early
    prof = traffic.burst_profile(np.array([0.0, on, on + arr["decay_s"]]), on,
                                 arr["scale"], arr["rise_s"], arr["decay_s"])
    assert prof[1] == pytest.approx(arr["scale"])
    assert prof[2] == pytest.approx(1 + (arr["scale"] - 1) / np.e)


def test_backlog_is_queued_at_once():
    cell, reqs = _gen("qwen2.5-3b.offline-batch", 9, seconds=30.0)
    assert len(reqs) == int(np.ceil(cell.workload["backlog_per_s"] * 30.0))
    assert all(r.due_s == 0.0 for r in reqs)


def test_tweet_instruction_is_shared():
    cell, a = _gen(TWEETS, 1)
    _, b = _gen(TWEETS, 2)
    n = cell.traffic["prefix_tokens"]
    assert n == 64
    assert all(np.array_equal(r.prompt[:n], a[0].prompt[:n]) for r in a + b)
