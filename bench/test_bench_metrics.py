"""The driver and the readers on a stand-in engine: a stall inside the
window moves the tail and the rate (they are taken over every request and
all the window's time, not over chunks), and the yardstick's arithmetic."""
import time
from types import SimpleNamespace

import numpy as np
import pytest

from bench import driver, roofline, run, traffic
from bench.tracer import Summary, _merge


class FakeEngine:
    """What the driver reads of ``ServingEngine``: a slot array, a queue,
    one token a row a step, ``dt`` seconds a step; step number ``stall_at``
    takes ``stall`` seconds more."""

    def __init__(self, max_batch=4, dt=0.002, stall_at=None, stall=0.0):
        self.active, self.queue, self.completed = {}, [], []
        self.pos = np.zeros(max_batch, np.int64)
        self.max_batch, self.dt, self.stall_at, self.stall = max_batch, dt, stall_at, stall
        self.step_count = 0
        self.paged = False

    def submit(self, req):
        self.queue.append(req)

    def step(self, decode_steps=1):
        for s in range(self.max_batch):
            if s not in self.active and self.queue:
                self.active[s] = self.queue.pop(0)
                self.pos[s] = 0
        time.sleep(self.dt + (self.stall if self.step_count == self.stall_at else 0.0))
        self.step_count += 1
        for s, req in list(self.active.items()):
            for _ in range(decode_steps):
                if len(req.output) < req.max_new_tokens:
                    req.output.append(1)
            self.pos[s] = len(req.prompt) + len(req.output) - 1
            if len(req.output) >= req.max_new_tokens:
                req.done_s = time.monotonic()
                self.completed.append(self.active.pop(s))
        return len(self.active)


MIX = {"arrivals": {"kind": "poisson"}, "prompt": {"kind": "uniform", "min": 4, "max": 8},
       "output": {"kind": "uniform", "min": 3, "max": 6}}


def _open_run(stall, mix=MIX, max_batch=4, dt=0.002):
    eng = FakeEngine(max_batch=max_batch, dt=dt, stall_at=100, stall=stall)
    arrivals = traffic.generate(mix, {"rate_per_s": 100.0}, 50, 3, 1.0)
    win = driver.Window(eng, k=1)
    win.run_open(arrivals, 1.0, 5.0)
    recs = list(win.recs.values())
    assert all(r.done is not None for r in recs)
    return SimpleNamespace(recs=recs, deadline=win.deadline, close=win.close,
                           window_steps=[s for s in win.steps if s.t0 < win.close])


def _offline_run(stall):
    eng = FakeEngine(stall_at=50, stall=stall)
    arrivals = traffic.generate(dict(MIX, arrivals={"kind": "backlog"}),
                                {"backlog_per_s": 5000.0}, 50, 3, 1.0)
    win = driver.Window(eng, k=2)
    win.run_offline(arrivals, 1.0)
    return SimpleNamespace(recs=list(win.recs.values()), close=win.close,
                           window_steps=list(win.steps))


def test_a_stall_moves_the_ttft_tail():
    base = run.reader("ttft_p95_ms")(_open_run(0.0))
    stalled = run.reader("ttft_p95_ms")(_open_run(0.3))
    # a 0.3 s stall holds every request due in it: far more than 5 % of them
    assert stalled > base + 150.0


def test_a_stall_moves_the_tpot_tail():
    # outputs of 20-40 tokens at 5 ms a step: about a seventh of the
    # requests are decoding when the stall comes
    mix = dict(MIX, output={"kind": "uniform", "min": 20, "max": 40})
    base = run.reader("tpot_p95_ms")(_open_run(0.0, mix, 64, 0.005))
    stalled = run.reader("tpot_p95_ms")(_open_run(0.3, mix, 64, 0.005))
    assert stalled > base + 5.0


def test_a_stall_moves_the_offline_rate():
    base = run.reader("output_tok_s")(_offline_run(0.0))
    stalled = run.reader("output_tok_s")(_offline_run(0.3))
    assert stalled < 0.8 * base


def test_open_loop_times_from_the_due_time():
    r = _open_run(0.0)
    assert all(x.first >= x.due and x.admit >= x.due - 1e-9 for x in r.recs)
    assert run.reader("queue_wait_p50_ms")(r) >= 0.0


def test_reader_falls_back_to_the_unsuffixed_file():
    assert run.reader("step_ms.open") is run.reader("step_ms.offline") or \
        run.reader("step_ms.open").__code__.co_code == run.reader("step_ms").__code__.co_code
    with pytest.raises(FileNotFoundError):
        run.reader("no_such_metric.open")


def test_positions_flops_sum_per_position():
    s = roofline.Shape(layers=2, d=8, heads=2, kv_heads=1, head_dim=4, vocab=16,
                       ffn=12, experts=0, top_k=0)
    per = [roofline.positions_flops(s, c - 1, c) for c in range(5, 12)]
    assert roofline.positions_flops(s, 4, 11) == pytest.approx(sum(per))
    # one position at context c: 2 per weight, 4 * hd * heads * layers * c
    w = 2 * (8 * 2 * 4 * 2 + 2 * 8 * 1 * 4 + 3 * 8 * 12) + 8 * 16
    assert per[0] == pytest.approx(2 * w + 4 * 4 * 2 * 2 * 5)


def test_paged_attention_cost_counts_each_key_once():
    s = roofline.Shape(layers=1, d=256, heads=2, kv_heads=1, head_dim=128, vocab=16,
                       ffn=1, experts=0, top_k=0)
    flops, n_bytes = roofline.paged_attention_cost(s, [0, 20], 4, 16)
    kv = 2 * (4 + 24) * 1 * 128 * 2
    q_out = 2 * 2 * 4 * 2 * 128 * 2
    assert n_bytes == kv + q_out + 4 * (1 + 2 + 2)
    assert flops == 4 * 128 * 2 * ((1 + 2 + 3 + 4) + (21 + 22 + 23 + 24))


def test_moe_counts_only_the_routed_experts():
    dense = roofline.Shape(1, 8, 2, 2, 4, 16, 12, 0, 0)
    moe = roofline.Shape(1, 8, 2, 2, 4, 16, 12, 64, 8)
    attn = 8 * 2 * 4 * 2 + 2 * 8 * 2 * 4
    assert roofline.matmul_params(dense) == attn + 3 * 8 * 12 + 8 * 16
    assert roofline.matmul_params(moe) == attn + 8 * 3 * 8 * 12 + 8 * 64 + 8 * 16


def test_trace_summary_unions_spans_and_names_gaps():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=dev)
    cu, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [ev("void paged_mixed_split_kernel<1>(float*)", 0, 10, cu),
              ev("paged_split_merge_kernel", 5, 12, cu),
              ev("lmhead_tc_kernel", 20, 30, cu),
              ev("aten::_local_scalar_dense", 11, 19, cpu),
              ev("aten::item", 10, 19, cpu)]
    s = Summary(events, 40e-6)
    assert s.busy_s == pytest.approx(22e-6)
    assert s.family_s(("paged_mixed_split_kernel", "paged_split_merge_kernel")) == \
        pytest.approx(12e-6)
    bd = s.breakdown()
    assert bd["idle_gaps"] == [["aten::_local_scalar_dense", pytest.approx(8e-6)]]
    assert bd["device_ops"][0][0] == "paged_mixed_split_kernel<1>"
    assert _merge([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


def test_no_trace_reads_nothing():
    r = SimpleNamespace(trace=None)
    for name in ("device_idle_pct.open", "paged_attention_roofline.open",
                 "lmhead_roofline.offline"):
        assert run.reader(name)(r) is None
