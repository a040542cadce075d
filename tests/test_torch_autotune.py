"""PyTorch port, ``kernels/decode_attention/autotune.py``: the page-size and
span-width sweeps on the CPU at tiny sizes give rows with the JAX sweeps'
keys, and ``pick_defaults`` reduces hand-made rows as the JAX package's
does, with and without span rows; the ``"cuda"`` defaults row is not
written from a sweep."""
import pytest
import torch

from repro.kernels.decode_attention import autotune as jax_autotune
from repro_torch.kernels.decode_attention import autotune

TINY = dict(total_tokens=64, B=2, Hq=4, Hkv=2, D=16, reps=2)


def test_sweep_page_size_rows_have_the_jax_keys():
    jrows = jax_autotune.sweep_page_size((8, 16), **TINY)
    rows = autotune.sweep_page_size((8, 16), **TINY, device="cpu")
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    assert [r["page_size"] for r in rows] == [8, 16]
    assert all(r["us_per_step"] > 0 and r["backend"] == "cpu" for r in rows)


def test_sweep_span_width_rows_have_the_jax_keys():
    jrows = jax_autotune.sweep_span_width((1, 4), page_size=8, **TINY)
    rows = autotune.sweep_span_width((1, 4), page_size=8, **TINY, device="cpu")
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    assert [r["span_width"] for r in rows] == [1, 4]
    for r in rows:
        assert r["us_per_token"] == pytest.approx(r["us_per_step"] / r["span_width"])


PAGE_ROWS = [{"page_size": ps, "us_per_step": us, "backend": "cpu"}
             for ps, us in ((8, 41.0), (16, 30.5), (32, 30.5), (64, 52.0))]
BLOCK_ROWS = [{"block_k": bk, "us_per_step": us, "backend": "cpu"}
              for bk, us in ((128, 9.0), (256, 7.5), (512, 8.0))]
SPAN_ROWS = [{"span_width": t, "us_per_step": us, "us_per_token": us / t, "backend": "cpu"}
             for t, us in ((1, 10.0), (2, 12.0), (4, 14.0), (8, 30.0), (16, 64.0))]


@pytest.mark.parametrize("span_rows", [None, SPAN_ROWS, SPAN_ROWS[:1]],
                         ids=["no span rows", "span rows", "width 1 only"])
def test_pick_defaults_matches_jax(span_rows):
    """Equal to the JAX reduction on the same rows (ties: the first row)."""
    assert (autotune.pick_defaults(PAGE_ROWS, BLOCK_ROWS, span_rows)
            == jax_autotune.pick_defaults(PAGE_ROWS, BLOCK_ROWS, span_rows))


def test_pick_defaults_without_block_rows_leaves_block_k_out():
    out = autotune.pick_defaults(PAGE_ROWS, span_rows=SPAN_ROWS)
    ref = jax_autotune.pick_defaults(PAGE_ROWS, BLOCK_ROWS, SPAN_ROWS)
    del ref["block_k"]
    assert out == ref == {"backend": "cpu", "page_size": 16, "chunk_size": 4,
                          "draft_len": 3}


def test_cuda_defaults_row_is_unswept():
    assert autotune.DEFAULTS["cuda"] == {"page_size": 16, "chunk_size": 16,
                                         "draft_len": 3, "lmhead_block_v": 128}


@pytest.mark.parametrize("sweep", ["sweep_page_size", "sweep_span_width"])
def test_sweeps_default_to_the_gpu(sweep, monkeypatch):
    """Without ``device`` a sweep times the card's kernels, as every port
    entry point resolves None to the GPU; with no GPU it raises instead of
    timing the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(autotune, sweep)((16,), **TINY)
