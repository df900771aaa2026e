"""Whole runs of the cell ``kimi_linear.prefill_16k`` at tiny size on the
CPU (``kimi_cells``' shrink and limits), as ``test_bench_new_cells.py``
runs ``moonlight.prefill_8k``: the result line is the contract's object
and correct; the same seed makes the same inputs and another seed others;
the control reads well above the sound run; a fault planted under the
timed path comes out not correct, one for each number the cell compares
(a KDA state among them). Then the cell's readers (``bench/lib/kda.py``)
on hand-built traces."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.tests import kimi_cells as KC


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", KC.CELLS)
def test_result_line_is_the_contracts_object(cell, trace, capsys):
    _, out = KC.measure(cell, seed=2 ** 31 + 17, trace=trace)
    harness.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"latent_err", "state_err", "exit_err"}
    assert line["failed"] == 0 and line["attempted"] > 0
    names = set(line["metrics"])
    kind = "per_layer" if trace else "end_to_end"
    metrics = harness.metrics_of(KC.BENCH, cell, kind)
    want = {m["name"] for m in metrics}
    assert names <= want
    if not trace:
        assert names == want == {"tokens_per_s", "setup_s"}
    else:   # on the CPU only the program's counters read
        assert names == {m["name"] for m in metrics
                         if m["source"] != "device_trace"}


def _inputs(drv):
    return [drv.params["embed"], drv.params["layers"]["kda"]["a_log"],
            drv.params["layers"]["moe"]["bias"], drv.prompts]


@pytest.mark.parametrize("cell", KC.CELLS)
def test_same_seed_same_inputs(cell):
    a, b = KC.driver(cell, seed=9), KC.driver(cell, seed=9)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cell", KC.CELLS)
def test_another_seed_other_inputs(cell):
    a = KC.driver(cell, seed=2 ** 31 + 5)
    b = KC.driver(cell, seed=2 ** 31 + 6)
    for d in (a, b):
        d.setup()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert x.shape == y.shape and not torch.equal(x, y)


@pytest.mark.parametrize("cell", KC.CELLS)
def test_control_reads_well_above_the_sound_run(cell):
    drv, out = KC.measure(cell, seed=3)
    sound = {k: c["value"] for k, c in out["checks"].items()}
    with torch.no_grad():
        ctl = drv.judge(drv.standin(drv.control_prec()))
    for k in ("latent_err", "state_err", "exit_err"):
        assert ctl[k] > 3 * sound[k] and ctl[k] > 0, (k, sound[k], ctl[k])
    assert any(ctl[k] > out["checks"][k]["limit"] for k in ctl)


def _broken(monkeypatch, fault):
    """Plant ``fault`` under the timed path: the last MLA layer's latent
    cache zeroed, the last KDA layer's state zeroed, or one exit embedding
    negated."""
    from repro_torch.launch import steps
    build = steps.build_lm_prefill

    def build_lm_prefill(*a, **kw):
        bundle = build(*a, **kw)
        fn = bundle.fn

        def step(params, tokens):
            out = fn(params, tokens)
            if fault == "latent_zero":
                out["latent_cache"][-1].zero_()
            elif fault == "state_zero":
                out["kda_state"][-1].zero_()
            else:
                out["exit_embs"][0, 0] = -out["exit_embs"][0, 0]
            return out
        bundle.fn = step
        return bundle
    monkeypatch.setattr(steps, "build_lm_prefill", build_lm_prefill)


@pytest.mark.parametrize("cell,fault,number", [
    ("kimi_linear.prefill_16k", "latent_zero", "latent_err"),
    ("kimi_linear.prefill_16k", "state_zero", "state_err"),
    ("kimi_linear.prefill_16k", "alter_exit", "exit_err")])
def test_a_broken_timed_path_is_not_correct(cell, fault, number,
                                            monkeypatch):
    _broken(monkeypatch, fault)
    _, out = KC.measure(cell, seed=4)
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], (number, out["checks"])


@pytest.mark.parametrize("cell", KC.CELLS)
def test_attribution_runs_and_reads_none_on_the_cpu(cell):
    """``bench/attribute.py``'s traced run takes the cell; on the CPU no
    reading has a device to read."""
    import time
    from bench import attribute
    drv = KC.driver(cell, seed=2 ** 31 + 3)
    with torch.no_grad():
        out, line = attribute.attribute(drv, KC.BENCH, cell,
                                        time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert all(v is None for v in line["readings"].values())


def test_the_parents_program_fails_the_cell_cleanly(monkeypatch):
    """A program without the hybrid config (the parent of the KDA layer)
    raises in set-up, before any window: the run exits non-zero soon."""
    from repro_torch.configs import base
    monkeypatch.delattr(base, "HybridLMConfig")
    with pytest.raises(ImportError):
        KC.driver("kimi_linear.prefill_16k").setup()


# -- the cell's readers on hand-built traces ---------------------------------

def _trace(kernel_s, busy_s):
    """A stand-in for ``bench.lib.trace.TraceSummary``: device seconds by
    kernel name and the busy time."""
    return SimpleNamespace(
        kernel_s=kernel_s, busy_s=busy_s,
        kernel_time=lambda f: sum(s for n, s in kernel_s.items() if f in n))


KDA_NAME = ("void (anonymous namespace)::kda_fwd_kernel(__nv_bfloat16 "
            "const*, float const*, float*, int, int, float)")
KERNELS = [
    (KDA_NAME, False),
    ("void flash_fwd_mla<192, 128>(CUtensorMap_st, float*, int)", False),
    ("void moe_gemm_wgmma<128, false>(CUtensorMap_st, int const*)", False),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", False),
    ("triton_rmsnorm_fwd", False),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>>", True),
    ("void (anonymous namespace)::moe_combine_rows<uint4>", True)]


@pytest.mark.parametrize("name,elementwise", KERNELS)
def test_elementwise_share_counts_only_elementwise_kernels(name,
                                                           elementwise):
    """``elementwise_share.kimi_linear`` charges a kernel exactly when it is
    elementwise work: the KDA and MLA kernels, which
    ``yardstick.kernel_class`` knows by no name, are not."""
    from bench.lib import kda
    other = "void at::native::unrolled_elementwise_kernel<copy>"
    rec = {"trace": _trace({name: 3.0, other: 1.0}, busy_s=10.0)}
    want = 40.0 if elementwise else 10.0
    assert kda.read_elementwise_share(rec) == pytest.approx(want)


def test_kda_roofline_reads_the_token_counter_against_the_kernel_time():
    """``kda_roofline.kimi_linear``: 6 dk dv operations a token-head at the
    bf16 peak, or q, k, v, o at 2 bytes, g at 4 a channel, beta at 4 and a
    final fp32 state a sequence-head at HBM speed, over the ``kda_``
    kernels' time; None without the program's counter (the parent's
    program) or a trace."""
    from bench.lib import kda
    from bench.metrics.yardstick import HBM_BYTES_PER_S
    c = {"linear_attn_config": {"head_dim": 128}}
    n, seq = 9 * 4 * 16384 * 32, 16384
    n_bytes = n * (4 * 128 * 2 + 128 * 4 + 4) + n / seq * 128 * 128 * 4
    assert kda.kda_bound_s(c, n, seq) == pytest.approx(
        n_bytes / HBM_BYTES_PER_S)        # bytes bound it, not operations
    tr = _trace({KDA_NAME: 0.2, "void flash_fwd_mla<192, 128>": 5.0},
                busy_s=7.0)
    rec = {"trace": tr, "config": c, "traffic": {"seq": seq},
           "counters": {"kda_tokens": n}}
    assert kda.read_kda_roofline(rec) == pytest.approx(
        100.0 * n_bytes / HBM_BYTES_PER_S / 0.2)
    assert kda.read_kda_roofline({**rec, "counters": {}}) is None
    assert kda.read_kda_roofline({**rec, "trace": None}) is None


def test_prefill_flops_count_every_kind_of_layer():
    """The cell's model FLOPs: cutting the stage from 12 layers to 8 drops
    exactly layers 9-12's FLOPs (three KDA layers, an MLA one, four MoE
    layers) and the exit head's at layer 12."""
    from bench.lib import kda
    c = harness.load_json(harness.ROOT / "bench/configs/"
                          "kimi-linear-48b-a3b.json")
    B, S = 4, 16384
    f12 = kda.prefill_flops(c, B, S)
    f8 = kda.prefill_flops({**c, "stage_layers": 8}, B, S)
    # layers 9-12: KDA 9-11, MLA 12, all MoE; the exit at 12 goes
    T = B * S
    d, E, K, F = 2304, 256, 8, 1024
    moe = 2.0 * T * (d * E + (K + 1) * 3 * d * F)
    dqk, dv, H, r = 192, 128, 32, 512
    mla = (2.0 * T * (d * H * dqk + d * (r + 64) + r * H * (128 + dv)
                      + H * dv * d) + 2.0 * B * H * (dqk + dv)
           * S * (S + 1) / 2)
    want = 3 * kda.kda_layer_flops(c, T) + mla + 4 * moe \
        + 2.0 * B * d * 1024
    assert f12 - f8 == pytest.approx(want)
