"""The metric readers and the trace's reduction on a made-up run: hand
counts of busy time, idle gaps, kernel classes and every metric."""
import pytest

from portbench.harness import roofline, spec
from portbench.harness.cell import Run
from portbench.harness.trace import Trace
from portbench.tests.tiny import one_thread  # noqa: F401

CFG = {"reference": "model", "n_layers": 1, "d_model": 8, "n_heads": 2,
       "n_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
       "ffn": "dense", "clients": 2, "batch_per_client": 1, "seq_len": 4}


def _trace():
    ops = [("void natural_pack_kernel(float4 const*)", 1.0, 0.5),
           ("ampere_sgemm_128x64_nn", 1.25, 1.0),      # overlaps the pack
           ("void at::native::BinaryFunctor<long, long, long>", 3.0, 1.0),
           ("Memcpy HtoD (Pageable -> Device)", 4.5, 0.25)]
    spans = [("local", 1.0, 2.5), ("fresh", 2.5, 5.0)]
    return Trace(ops=ops, spans=spans, start=1.0, end=5.0)


def test_trace_reduction():
    tr = _trace()
    assert tr.window_s == 4.0
    assert tr.busy_s() == pytest.approx(1.25 + 1.0 + 0.25)
    assert tr.idle_gaps() == [("local step", pytest.approx(0.75)),
                              ("fresh step", pytest.approx(0.5)),
                              ("fresh step", pytest.approx(0.25))]
    assert dict(tr.by_class()) == {
        "codec kernels": 0.5, "gemm": 1.0,
        "int64 elementwise (threefry draws)": 1.0, "copies and fills": 0.25}
    assert tr.seconds_of(("natural_",)) == 0.5
    assert dict(tr.by_class("fresh")) == {
        "int64 elementwise (threefry draws)": 1.0, "copies and fills": 0.25}
    assert dict(tr.by_class("local")) == {"codec kernels": 0.5, "gemm": 1.0}


def test_readers():
    ref = spec.reference(CFG)
    shapes = ref.param_shapes(CFG)
    run = Run(cell={"transport": "leafwise"}, config=CFG, shapes=shapes, setup_s=12.5,
              window_s=2.0, branches=[0, 0, 1, 2], step_seconds=[
                  (0, 0.5), (0, 0.75), (1, 0.25), (2, 0.5)],
              peak_bytes=3 * 10 ** 9, trace=_trace(), trace_fresh_rounds=1)
    read = {m: spec.reader(m)(run) for m in (
        "train_tokens_per_s", "peak_mem_gb", "setup_s", "local_step_s",
        "fresh_step_s", "mfu", "codec_roofline", "idle_share")}
    assert read["train_tokens_per_s"] == 2 * 1 * 4 * 2 / 2.0
    assert read["peak_mem_gb"] == 3.0
    assert read["setup_s"] == 12.5
    assert read["local_step_s"] == 0.625
    assert read["fresh_step_s"] == 0.25
    assert read["mfu"] == pytest.approx(
        100 * 2 * ref.train_flops(CFG, shapes) / (2.0 * 67e12))
    assert read["codec_roofline"] == pytest.approx(
        100 * roofline.codec_bytes(CFG, shapes) / 3.35e12 / 0.5)
    assert read["idle_share"] == pytest.approx(100 * (1 - 2.5 / 4.0))
    quiet = Run(cell={}, config=CFG, shapes=shapes, setup_s=1.0,
                window_s=1.0, branches=[1, 2], step_seconds=[],
                peak_bytes=0)
    for metric in ("local_step_s", "fresh_step_s", "mfu",
                   "codec_roofline", "idle_share", "peak_mem_gb"):
        assert spec.reader(metric)(quiet) is None, metric
