"""Whole runs of the cell ``moonlight.prefill_8k`` at tiny size on the
CPU (``new_cells``' shrink and limits), as ``test_bench_cells.py`` runs
the cells before it: the result line is the contract's object and
correct; the same seed makes the same inputs and another seed others; the
control reads well above the sound run; and a fault planted under the
timed path comes out not correct, one for each number the cell compares.
Then the cell's readers (``bench/lib/mla.py``) on hand-built traces."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.tests import new_cells as NC


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", NC.CELLS)
def test_result_line_is_the_contracts_object(cell, trace, capsys):
    _, out = NC.measure(cell, seed=2 ** 31 + 17, trace=trace)
    harness.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    names = set(line["metrics"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = harness.metrics_of(NC.BENCH, cell, kind)
    want = {m["name"] for m in metrics}
    assert names <= want
    if not trace:
        assert names == want and "setup_s" in names
    else:   # on the CPU only the program's counters read
        assert names == {m["name"] for m in metrics
                         if m["source"] != "device_trace"}


def _inputs(drv):
    return [drv.params["embed"], drv.params["layers"]["moe"]["bias"],
            drv.prompts]


@pytest.mark.parametrize("cell", NC.CELLS)
def test_same_seed_same_inputs(cell):
    a, b = NC.driver(cell, seed=9), NC.driver(cell, seed=9)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cell", NC.CELLS)
def test_another_seed_other_inputs(cell):
    a = NC.driver(cell, seed=2 ** 31 + 5)
    b = NC.driver(cell, seed=2 ** 31 + 6)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert x.shape == y.shape and not torch.equal(x, y)


SEPARATES = {"moonlight.prefill_8k": ["latent_err", "exit_err"]}


@pytest.mark.parametrize("cell", NC.CELLS)
def test_control_reads_well_above_the_sound_run(cell):
    drv, out = NC.measure(cell, seed=3)
    sound = {k: c["value"] for k, c in out["checks"].items()}
    with torch.no_grad():
        ctl = drv.judge(drv.standin(drv.control_prec()))
    for k in SEPARATES[cell]:
        assert ctl[k] > 3 * sound[k] and ctl[k] > 0, (k, sound[k], ctl[k])
    assert any(ctl[k] > out["checks"][k]["limit"] for k in SEPARATES[cell])


def _broken(monkeypatch, fault):
    """Plant ``fault`` under the timed path: the last layer's latent cache
    zeroed, or one exit embedding negated."""
    from repro_torch.launch import steps
    build = steps.build_lm_prefill

    def build_lm_prefill(*a, **kw):
        bundle = build(*a, **kw)
        fn = bundle.fn

        def step(params, tokens):
            out = fn(params, tokens)
            if fault == "latent_zero":
                out["latent_cache"][-1].zero_()
            else:
                out["exit_embs"][0, 0] = -out["exit_embs"][0, 0]
            return out
        bundle.fn = step
        return bundle
    monkeypatch.setattr(steps, "build_lm_prefill", build_lm_prefill)


@pytest.mark.parametrize("cell,fault,number", [
    ("moonlight.prefill_8k", "latent_zero", "latent_err"),
    ("moonlight.prefill_8k", "alter_exit", "exit_err")])
def test_a_broken_timed_path_is_not_correct(cell, fault, number,
                                            monkeypatch):
    _broken(monkeypatch, fault)
    _, out = NC.measure(cell, seed=4)
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], (number, out["checks"])


@pytest.mark.parametrize("cell", NC.CELLS)
def test_attribution_runs_and_reads_none_on_the_cpu(cell):
    """``bench/attribute.py``'s traced run takes the cell; on the CPU no
    reading has a device to read."""
    import time
    from bench import attribute
    drv = NC.driver(cell, seed=2 ** 31 + 3)
    with torch.no_grad():
        out, line = attribute.attribute(drv, NC.BENCH, cell,
                                        time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert all(v is None for v in line["readings"].values())


# -- the cell's readers on hand-built traces ---------------------------------

def _trace(kernel_s, busy_s):
    """A stand-in for ``bench.lib.trace.TraceSummary``: device seconds by
    kernel name and the busy time."""
    return SimpleNamespace(
        kernel_s=kernel_s, busy_s=busy_s,
        kernel_time=lambda f: sum(s for n, s in kernel_s.items() if f in n))


# kernel names as a device trace gives them, and whether each is
# elementwise work on the Moonlight prefill
KERNELS = [
    ("void flash_fwd_mla<192, 128>(CUtensorMap_st, float*, int)", False),
    ("void flash_fwd_wgmma<128>(CUtensorMap_st, float*, int)", False),
    ("void moe_gemm_wgmma<128, false>(CUtensorMap_st, int const*)", False),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", False),
    ("triton_rmsnorm_fwd", False),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", True),
    ("void at::native::index_elementwise_kernel<128, 4>", True),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex", True)]


@pytest.mark.parametrize("name,elementwise", KERNELS)
def test_elementwise_share_counts_only_elementwise_kernels(name,
                                                           elementwise):
    """``elementwise_share.moonlight`` charges a kernel to the elementwise
    share exactly when it is elementwise work: the MLA flash forward, which
    ``yardstick.kernel_class`` knows by no name, is not."""
    from bench.lib import mla
    other = "void at::native::unrolled_elementwise_kernel<copy>"
    rec = {"trace": _trace({name: 3.0, other: 1.0}, busy_s=10.0)}
    want = 40.0 if elementwise else 10.0
    assert mla.read_elementwise_share(rec) == pytest.approx(want)


@pytest.mark.parametrize("trace", [None, _trace({}, busy_s=0.0)])
def test_elementwise_share_reads_none_without_device_time(trace):
    from bench.lib import mla
    assert mla.read_elementwise_share({"trace": trace}) is None


def test_elementwise_share_metric_file_is_the_readers():
    from bench import harness
    from bench.lib import mla
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    metric = next(m for m in bench["per_layer"]
                  if m["name"] == "elementwise_share.moonlight")
    assert metric["workloads"] == NC.CELLS
    assert metric["moves"] == "tokens_per_s"
    assert harness.load_reader(metric["name"]).read is \
        mla.read_elementwise_share


def test_gemm_roofline_needs_the_assignment_counter():
    """``moe_gemm_roofline.moonlight``: 6 · assignments · d · F operations
    at the bf16 peak over the ``moe_gemm`` kernels' time; None where the
    program counted no assignment (a program without the counter)."""
    from bench.lib import mla
    from bench.metrics.yardstick import PEAK_FLOPS
    c = {"hidden_size": 2048, "moe_intermediate_size": 1408}
    tr = _trace({"void moe_gemm_wgmma<128, false>": 2.0,
                 "void flash_fwd_mla<192, 128>": 5.0}, busy_s=7.0)
    n = 10 ** 9
    got = mla.read_gemm_roofline({"trace": tr, "config": c,
                                  "counters": {"assignments": n}})
    assert got == pytest.approx(100.0 * 6 * n * 2048 * 1408
                                / PEAK_FLOPS["bf16"] / 2.0)
    assert mla.read_gemm_roofline({"trace": tr, "config": c,
                                   "counters": {}}) is None


@pytest.mark.parametrize("causal,pairs", [(True, 4096 * 4097 / 2),
                                          (False, 4096 * 4096)])
def test_flash_call_bound_counts_live_pairs_at_both_head_dims(causal,
                                                              pairs):
    """An MLA call's bound at the cell's widths is its operations,
    2 · B · H · pairs · (192 + 128) at the bf16 peak, far above its
    bytes."""
    from bench.lib import mla
    from bench.metrics.yardstick import PEAK_FLOPS
    call = dict(B=2, Sq=4096, Skv=4096, H=16, KV=16, D=192, causal=causal,
                itemsize=2)
    want = 2.0 * 2 * 16 * pairs * (192 + 128) / PEAK_FLOPS["bf16"]
    assert mla.flash_call_bound_s(call, 128) == pytest.approx(want)
