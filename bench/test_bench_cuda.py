"""On the card: the harness's whole path through the CUDA kernels at the
small sizes, and the float8 control, which has to fail where the program
passes.  Skips where torch finds no CUDA device; run on the card with
``python -m pytest -m cuda bench/test_bench_cuda.py``."""
import dataclasses

import pytest

from bench import control, run
from bench._small import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", ["qwen2.5-3b.chat-long", "olmoe-1b-7b.offline-batch"])
def test_the_control_fails_on_the_card_and_the_program_does_not(card, name, seed):
    cell = small_cell(name)
    res = run.run_cell(cell, seed, 3.0, False, device=str(card), control=True)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["checks"]
    v = control.verdict(res, cell.workload["limits"])
    assert not v["control_correct"], res["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmoe-1b-7b.offline-batch", "qwen2.5-3b.offline-batch"])
def test_a_traced_run_reads_every_layer_on_the_card(card, name):
    cell = small_cell(name)
    # enough backlog that the card is still busy in the traced last second
    cell = dataclasses.replace(cell, workload=dict(cell.workload, backlog_per_s=400.0))
    res = run.run_cell(cell, 5, 5.0, True, device=str(card))
    assert res["correct"], res["checks"]
    want = {m.name for m in cell.per_layer}
    got = set(res["metrics"])
    rooflines = {n for n in want if "_roofline" in n}
    # a kernel with no device time in the trace leaves its roofline out of
    # the line, never 0: the small float32 MoE cell may run no such kernel
    assert want - rooflines <= got <= want
    if cell.config["torch_dtype"] == "bfloat16":
        assert got == want
    for n in got & rooflines:
        assert 0 < res["metrics"][n]["value"] <= 105, (n, res["metrics"][n])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.05
    assert res["breakdown"]["device_ops"]
