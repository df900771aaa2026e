"""Port parity: the analytic half of the dry run. Every HBM account of
``launch.steps`` against the reference's for every (arch x shape) cell on
both production meshes; ``launch.hlo_analysis``'s ``Roofline`` on
tests/test_hlo_analysis.py's cases with each term the same arithmetic on
the H100's constants, ``linear_fit_two`` and ``flash_loop_correction``
equal to the reference's; ``launch.dryrun.main`` over every cell on both
meshes with no CUDA call."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import base as JC
from repro.launch import hlo_analysis as JH
from repro.launch import steps as JS
from repro_torch.configs import base as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import hlo_analysis as TH
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps as TS

CELLS = [(a, s.name, mp) for a in JC.list_archs()
         for s in JC.get_arch(a).shapes if not s.skip_reason
         for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_hbm_accounts_equal_reference(arch, shape, multi_pod):
    jspec, tspec = JC.get_arch(arch), TC.get_arch(arch)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dims = (2, 16, 16) if multi_pod else (16, 16)
    jm = AbstractMesh(dims, axes, axis_types=(AxisType.Auto,) * len(axes))
    tm = TMESH.make_production_mesh(multi_pod=multi_pod)
    n_dev = int(np.prod(dims))
    jb = JS.build_step(jspec, jspec.shape(shape), jm, multi_pod=multi_pod)
    tb = TS.build_step(tspec, tspec.shape(shape), device="meta", mesh=tm)
    want = JS.analytic_hbm_bytes_for(jspec, jspec.shape(shape), jb, jm, n_dev)
    got = TS.analytic_hbm_bytes_for(tspec, tspec.shape(shape), tb, tm, n_dev)
    assert got == want and got > 0
    assert tb.model_flops == jb.model_flops


@pytest.mark.parametrize("fn,args", [
    ("lm_train_hbm_bytes", ("qwen2-1.5b", 256, 4096, 256, 16, 16, 4)),
    ("lm_train_hbm_bytes", ("qwen3-moe-30b-a3b", 64, 4096, 512, 16, 32, 1)),
    ("lm_prefill_hbm_bytes", ("deepseek-67b", 32, 32768, 256, 16, 16)),
    ("lm_decode_hbm_bytes", ("minitron-8b", 128, 32768, 512)),
    ("mem_hbm_bytes", ("recall-imagebind", 512, 256, 16, "train", None)),
    ("mem_hbm_bytes", ("recall-imagebind", 64, 8, 2, "serve", ("vision",))),
    ("recsys_hbm_bytes", ("dlrm-mlperf", 65536, 256, "train", 0)),
    ("recsys_hbm_bytes", ("dien", 512, 8, "retrieval", 1000000)),
    ("recsys_hbm_bytes", ("bst", 1, 1, "serve", 0)),
    ("gnn_hbm_bytes", ("gatedgcn", 2449029, 61859140, 256, True)),
    ("gnn_hbm_bytes", ("gatedgcn", 1000, 5000, 1, False))])
def test_hbm_account_functions_equal_reference(fn, args):
    arch, rest = args[0], args[1:]
    want = getattr(JS, fn)(JC.get_arch(arch).model, *rest)
    assert getattr(TS, fn)(TC.get_arch(arch).model, *rest) == want


ROOF_CASES = [
    # tests/test_hlo_analysis.py's case, on the H100's peaks
    dict(flops_per_device=989e12, hbm_bytes_per_device=3.35e12 / 2,
         wire_bytes_per_device=0.0, n_devices=2, model_flops_total=2 * 989e12),
    dict(flops_per_device=1e12, hbm_bytes_per_device=3.35e12,
         wire_bytes_per_device=9e9, n_devices=8, model_flops_total=4e12,
         hbm_bytes_upper=1e13),
    dict(flops_per_device=1e9, hbm_bytes_per_device=1e6,
         wire_bytes_per_device=450e9, n_devices=4, model_flops_total=1e9,
         ici_links=4),
    dict(flops_per_device=0.0, hbm_bytes_per_device=0.0,
         wire_bytes_per_device=0.0, n_devices=1, model_flops_total=0.0)]


@pytest.mark.parametrize("kw", ROOF_CASES)
def test_roofline_terms_on_h100_constants(kw):
    r = TH.Roofline(**kw)
    links = kw.get("ici_links", 18)
    assert r.compute_s == kw["flops_per_device"] / 989e12
    assert r.memory_s == kw["hbm_bytes_per_device"] / 3.35e12
    assert r.memory_s_upper == kw.get("hbm_bytes_upper", 0.0) / 3.35e12
    assert r.collective_s == kw["wire_bytes_per_device"] / (25e9 * links)
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    assert r.bottleneck == max(terms, key=terms.get)
    assert r.step_s == max(terms.values())
    total = kw["flops_per_device"] * kw["n_devices"]
    assert r.useful_ratio == (kw["model_flops_total"] / total if total else 0.0)
    denom = r.step_s * 989e12 * kw["n_devices"]
    assert r.mfu == (kw["model_flops_total"] / denom if denom else 0.0)
    # the reference's fields and keys
    j = JH.Roofline(**{k: v for k, v in kw.items()})
    assert [f.name for f in dataclasses.fields(TH.Roofline)] == \
        [f.name for f in dataclasses.fields(JH.Roofline)]
    assert r.as_dict().keys() == j.as_dict().keys()
    if kw["flops_per_device"] == 989e12:
        assert r.compute_s == pytest.approx(1.0)
        assert r.memory_s == pytest.approx(0.5)
        assert r.bottleneck == "compute"
        assert r.useful_ratio == pytest.approx(1.0)
        assert r.mfu == pytest.approx(1.0)


def test_h100_constants():
    assert TMESH.PEAK_FLOPS_BF16 == 989e12 and TMESH.PEAK_FLOPS_FP32 == 67e12
    assert TMESH.HBM_BW == 3.35e12
    assert TMESH.NVLINK_BW_PER_LINK == 25e9 and TMESH.NVLINK_LINKS == 18


@pytest.mark.parametrize("args", [(1, 13, 2, 16, 28), (1, 5.5, 2, 4.25, 48),
                                  (2, 100.0, 4, 60.0, 1), (1, 0, 3, 9, 0)])
def test_linear_fit_two_equals_reference(args):
    assert TH.linear_fit_two(*args) == JH.linear_fit_two(*args)


@pytest.mark.parametrize("kw", [
    dict(B=1, KV=1, G=1, D=8, Sq=16, Skv=16, bq=16, bkv=16, train=False,
         remat=False),
    dict(B=1, KV=1, G=1, D=8, Sq=32, Skv=32, bq=16, bkv=16, train=False,
         remat=False),
    dict(B=8, KV=2, G=6, D=128, Sq=4096, Skv=4096, bq=512, bkv=512,
         train=True, remat=True),
    dict(B=4, KV=8, G=8, D=128, Sq=4096, Skv=4096, bq=512, bkv=512,
         train=True, remat=False, causal_skip=True),
    dict(B=2, KV=4, G=1, D=64, Sq=257, Skv=300, bq=256, bkv=256,
         train=False, remat=False, causal_skip=True, dtype_bytes=4)])
def test_flash_loop_correction_equals_reference(kw):
    assert TH.flash_loop_correction(**kw) == JH.flash_loop_correction(**kw)


def test_dryrun_main_writes_every_cell_with_no_cuda_call(tmp_path,
                                                         monkeypatch, capsys):
    def no_cuda(*a, **k):
        raise AssertionError("the dry run touched CUDA")
    for name in ("is_available", "device_count", "init", "_lazy_init",
                 "synchronize", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    TD.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "DRY-RUN OK" in out
    cells = [(a, s) for a in TC.list_archs() for s in TC.get_arch(a).shapes]
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 * len(cells)
    for arch, s in cells:
        for mesh in ("16_16", "2_16_16"):
            res = json.loads((tmp_path / f"{arch}__{s.name}__{mesh}__native"
                                          ".json").read_text())
            if s.skip_reason:
                assert res["status"] == "skipped"
                assert res["skip_reason"] == s.skip_reason
                assert "SKIPPED" in out
                continue
            assert res["status"] == "ok"
            mem = res["memory"]
            assert mem["argument_bytes"] == mem["params_bytes"] + \
                mem["opt_state_bytes"] + mem["input_bytes"] > 0
            assert mem["temp_bytes"] is None
            r = res["roofline"]
            assert r["wire_bytes_per_device"] == 0 == r["hbm_bytes_upper"]
            assert res["wire_bytes"] == "not counted"
            assert r["flops_per_device"] == \
                res["model_flops_total"] / res["n_devices"]


def test_dryrun_window_cell_and_argument_bytes():
    """A skipped cell runs with --window; the argument bytes are the sum
    of the shard shapes (qwen2-1.5b decode on 16 x 16: the params as
    sharded, the caches over batch and sequence)."""
    res = TD.analyze_cell("qwen2-1.5b", "long_500k", window=8192,
                          verbose=False)
    assert res["status"] == "ok" and res["window"] == 8192
    res = TD.analyze_cell("qwen2-1.5b", "decode_32k", verbose=False)
    spec = TC.get_arch("qwen2-1.5b")
    cfg, shape = spec.model, spec.shape("decode_32k")
    cache = 2 * (cfg.n_layers * (shape.global_batch // 16)
                 * (shape.seq_len // 16) * cfg.n_kv_heads * cfg.head_dim * 2)
    assert res["memory"]["input_bytes"] == cache + 2 * 4 * shape.global_batch
    assert res["memory"]["opt_state_bytes"] == 0
    with pytest.raises(SystemExit):
        TD.main([])
