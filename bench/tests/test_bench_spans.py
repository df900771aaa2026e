"""``bench/lib/spans.py`` on hand-built profiler events (host ranges and
device operations, times in microseconds), and ``bench/attribute.py``'s
traced run on the tiny CPU cells."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench import attribute
from bench.lib import spans as SP
from bench.lib.trace import TraceSummary
from bench.metrics import yardstick as Y
from bench.tests import tiny

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def ev(name, a, b, *, dev=False, id=0, linked=0):
    return SimpleNamespace(name=name, device_type=CUDA if dev else CPU,
                           time_range=SimpleNamespace(start=a, end=b), id=id,
                           linked_correlation_id=linked)


def drain_window():
    """A 100-us window: a drain whose second exit group starts while the
    card is idle after the first group's activations went to the host."""
    return [ev("bench.window", 0, 100), ev("bench.drain", 0, 90),
            ev("engine.drain", 2, 88), ev("engine.continue", 10, 30),
            ev("store.add_batch", 30, 60), ev("store.acts_to_host", 40, 50),
            ev("aten::copy_", 40, 50, id=3), ev("engine.continue", 60, 80),
            ev("gemm_kernel", 10, 45, dev=True, id=101),
            ev("gemm_kernel", 65, 80, dev=True, id=102)]


def test_an_idle_gap_is_cut_at_the_span_boundaries():
    st = SP.SpanTrace(drain_window())
    got = {k: round(v * 1e6, 9) for k, v in st.span_idle_s().items()}
    # gaps [0, 10], [45, 65], [80, 100]: the middle one crosses from
    # store.acts_to_host through store.add_batch into engine.continue
    assert got == {SP.HARNESS: 14.0, "engine.drain": 16.0,
                   "store.acts_to_host": 5.0, "store.add_batch": 10.0,
                   "engine.continue": 5.0}
    labels = dict(st.top_gaps(20))
    assert labels["bench.drain | store.acts_to_host | aten::copy_"] == \
        pytest.approx(5e-6)
    assert labels["bench.drain | engine.continue | python"] == \
        pytest.approx(5e-6)
    assert labels["bench (harness) | python"] == pytest.approx(12e-6)
    assert all(len(k) <= SP.LABEL_CHARS for k in labels)


def test_a_layers_kernels_go_to_the_stage_that_ran_the_layer():
    events = [ev("bench.window", 0, 100), ev("engine.drain", 0, 100),
              ev("engine.superficial", 0, 40), ev("layer.mlp", 10, 30),
              ev("aten::mm", 12, 13, id=7),
              ev("engine.continue", 50, 90), ev("layer.mlp", 60, 80),
              ev("aten::mm", 61, 62, id=8),
              ev("sgemm_simt", 20, 30, dev=True, id=100, linked=7),
              ev("xmma_gemm", 70, 75, dev=True, id=101, linked=8)]
    st = SP.SpanTrace(events)
    by_stage = {k: round(v * 1e6, 9)
                for k, v in st.span_device_s(stage=True).items()}
    assert by_stage == {("engine.superficial", "matmul (cuBLAS)"): 10.0,
                        ("engine.continue", "matmul (cuBLAS)"): 5.0}
    assert {k: round(v * 1e6, 9) for k, v in st.span_device_s().items()} \
        == {("layer.mlp", "matmul (cuBLAS)"): 15.0}
    assert st.top_kernels(stage=True)["engine.continue"][0][0] == \
        "xmma_gemm"


def test_engine_store_and_harness_idle_add_up_to_the_window_idle():
    events = drain_window()
    st = SP.SpanTrace(events)
    summ = TraceSummary(events, window_s=100e-6)
    assert st.busy_s == pytest.approx(summ.busy_s) == pytest.approx(50e-6)
    parts = [st.idle_share("engine."), st.idle_share("store."),
             st.idle_share(SP.HARNESS)]
    assert parts == pytest.approx([21.0, 15.0, 14.0])
    assert sum(parts) == pytest.approx(
        100.0 * (1 - summ.busy_s / summ.window_s))


def test_device_time_goes_to_the_span_of_its_launch():
    events = [
        ev("bench.window", 0, 100), ev("layer.attn", 0, 10),
        ev("layer.mlp", 10, 30),
        # an op inside layer.mlp; its kernel runs after the span closed
        ev("aten::mm", 12, 13, id=7), ev("gemm_a", 40, 50, dev=True,
                                          id=100, linked=7),
        # no torch op linked: the runtime launch inside layer.mlp
        ev("cuLaunchKernel", 20, 21, id=200),
        ev("rmsnorm_kernel", 50, 52, dev=True, id=200),
        # an op after every span
        ev("aten::add", 90, 91, id=8),
        ev("elementwise_add", 60, 62, dev=True, id=300, linked=8),
        # linked to nothing recorded
        ev("gemm_b", 70, 80, dev=True, id=400, linked=99)]
    st = SP.SpanTrace(events)
    got = {k: round(v * 1e6, 9) for k, v in st.span_device_s().items()}
    other = Y.ELEMENTWISE
    assert got == {("layer.mlp", "matmul (cuBLAS)"): 10.0,
                   ("layer.mlp", "rmsnorm (Triton kernel)"): 2.0,
                   (SP.OUTSIDE, other): 2.0,
                   (SP.UNLINKED, "matmul (cuBLAS)"): 10.0}
    assert st.span_time("layer.mlp") == pytest.approx(12e-6)
    kernels = st.top_kernels()
    assert kernels["layer.mlp"] == [["gemm_a", pytest.approx(10e-6)],
                                    ["rmsnorm_kernel", pytest.approx(2e-6)]]
    assert st.unlinked_share() == pytest.approx(100 * 10 / 24)


def test_a_spans_device_annotation_adds_nothing_to_busy_time():
    events = [ev("bench.window", 0, 100), ev("layer.mlp", 10, 30),
              ev("aten::mm", 12, 13, id=7),
              ev("layer.mlp", 10, 40, dev=True),      # the annotation
              ev("gemm", 20, 30, dev=True, id=100, linked=7)]
    st = SP.SpanTrace(events)
    assert st.busy_s == pytest.approx(10e-6)
    assert TraceSummary(events, 100e-6).busy_s == pytest.approx(10e-6)
    assert sum(st.span_device_s().values()) == pytest.approx(10e-6)


def test_mlp_flops_is_the_yardsticks_swiglu_term():
    S, d, d_ff = 257, 1280, 5120
    assert Y.encoder_layer_flops(S, d, d_ff) == pytest.approx(
        2.0 * S * 4 * d * d + SP.mlp_flops(S, d, d_ff) + 4.0 * S * S * d)


def test_mlp_mfu_reads_the_mlp_spans_device_time():
    events = [ev("bench.window", 0, 2e6), ev("layer.mlp", 0, 10),
              ev("aten::mm", 1, 2, id=7),
              ev("gemm", 10, 1e6 + 10, dev=True, id=100, linked=7)]
    cfg = {"family": "lm", "num_hidden_layers": 2, "hidden_size": 64,
           "intermediate_size": 128}
    rec = {"config": cfg, "counters": {"tokens": 1000},
           "flops": {"bf16": 1.0}}
    r = SP.readings(SP.SpanTrace(events), rec)
    want = 100 * SP.mlp_flops(2000, 64, 128) / Y.PEAK_FLOPS["bf16"] / 1.0
    assert r["mlp_mfu"] == pytest.approx(want)
    assert r["unlinked_share"] == 0.0
    assert r["engine_idle_share"] == r["store_idle_share"] == 0.0
    assert r["harness_idle_share"] == pytest.approx(50.0)


def test_kineto_events_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("engine.drain"):
                with record_function("layer.mlp"):
                    x @ x
    events = SP.kineto_events(prof)
    assert {"bench.window", "engine.drain", "aten::mm"} <= \
        {e.name for e in events}
    st = SP.SpanTrace(events)
    assert st.counts == {"engine.drain": 1, "layer.mlp": 1}
    assert st.busy_s == 0 and st.window_s > 0
    # no device operation: the whole window is idle, most of it the drain's
    assert sum(st.span_idle_s().values()) == pytest.approx(st.window_s)
    assert st.span_idle_s()["engine.drain"] > 0


@pytest.mark.parametrize("cell", ["recall.embed", "qwen2.prefill_2k"])
def test_the_readings_are_none_on_a_tiny_cpu_run(cell):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        drv = tiny.driver(cell, seed=2 ** 31 + 3)
        with torch.no_grad():
            out, line = attribute.attribute(drv, tiny.BENCH, cell,
                                            time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert out["correct"] is True, out["checks"]
    assert set(line["readings"]) == {"engine_idle_share", "store_idle_share",
                                     "harness_idle_share", "mlp_mfu",
                                     "unlinked_share"}
    assert all(v is None for v in line["readings"].values())
    assert line["idle_share"] is None and "table" not in line
