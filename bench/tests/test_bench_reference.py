"""The plain reference against the port on the CPU, at tiny sizes: the
encoder tower with its exits, the predictor, int4 quantization and the
top-k scan, and the Qwen2 prefill with its K/V cache."""
import numpy as np
import pytest
import torch

from bench.drivers import prefill as PF
from bench.drivers import recall_common as RC
from bench.reference import imagebind as RI
from bench.reference import int4 as R4
from bench.reference import layers as RL
from bench.reference import predictor as RP
from bench.reference import qwen2 as RQ
from bench.reference.precision import matmul, round_fp8, round_tf32
from bench.tests import tiny


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several worker processes at once: one torch
    thread each while these tests run (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mem(seed=3):
    cfg = tiny.tiny_files("recall.embed")["config"]
    params = RC.make_params(cfg, ["vision", "text"], seed, "cpu")
    return cfg, params


@pytest.mark.parametrize("modality", ["vision", "text"])
def test_tower_and_exit_head_match_the_port(modality):
    from repro_torch.models import imagebind as IB
    cfg, params = _mem()
    mem, rc = RC.mem_configs(cfg)
    pool = RC.make_pool(cfg, 6, 11, "cpu", ["vision", "text"])
    x = pool[modality]
    t = RC.tower_cfg(cfg, modality)
    got = IB.mem_embed_all_exits(params, mem, rc, modality, x)
    ref = RI.tower(params["towers"][modality], x, n_heads=t["n_heads"],
                   eps=cfg["norm_eps"], end=t["n_layers"])
    exits = RI.exit_layers(t["n_layers"], cfg["recall"]["exit_interval"])
    want = RL.exit_embedding(params["towers"][modality],
                             ref["cls"][[e - 1 for e in exits]],
                             cfg["norm_eps"])
    tol = 1e-5 if modality == "vision" else 3e-2   # text runs bf16
    assert torch.allclose(got["exit_embs"].float(), want, atol=tol)
    assert torch.allclose(got["pooled"].float(), ref["cls"],
                          atol=tol * 100, rtol=tol)


def test_predictor_logits_match_the_port():
    from repro_torch.core import preexit as PE
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(20, 32, generator=g)
    p = RP.fit(feats, torch.arange(20) % 5, hidden=16, n_exits=5, seed=1,
               steps=20)
    assert torch.allclose(PE.predictor_logits(p, feats), RP.logits(p, feats),
                          atol=1e-6)


def test_exit_labels_are_monotone_with_the_stated_mean():
    rng = np.random.default_rng(0)
    diff = rng.uniform(size=512)
    exits = RI.exit_layers(32, 4)
    lab = RP.exit_labels(diff, exits, 21.4)
    assert abs(np.asarray(exits)[lab].mean() - 21.4) < 0.15
    order = np.argsort(diff)
    assert (np.diff(lab[order]) >= 0).all()


def test_int4_matches_the_port_bit_for_bit():
    from repro_torch.core.quantize import dequantize_int4_np, quantize_int4_np
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 80)).astype(np.float32)
    x[3] = 0.0
    p, s = quantize_int4_np(x)
    codes, scale = R4.quantize(torch.from_numpy(x))
    assert np.array_equal(scale.numpy(), s)
    assert np.array_equal(R4.dequantize(codes, scale).numpy(),
                          dequantize_int4_np(p, s))
    assert R4.cell_gap(torch.from_numpy(x),
                       torch.from_numpy(dequantize_int4_np(p, s))) == 0.0


def test_topk_and_cell_gap():
    g = torch.Generator().manual_seed(2)
    rows, q = torch.randn(50, 16, generator=g), torch.randn(3, 16, generator=g)
    v, i = R4.topk(q, rows, 5)
    s = q @ rows.T
    assert torch.equal(i, s.argsort(dim=-1, descending=True)[:, :5])
    x = torch.randn(4, 16, generator=g)
    _, scale = R4.quantize(x)
    off = R4.roundtrip(x) + 0.7 * scale          # past the cell's edge
    assert abs(R4.cell_gap(x, off) - 0.7) < 0.5 + 1e-6


def test_precisions_lower_the_products():
    g = torch.Generator().manual_seed(4)
    a, b = torch.randn(32, 64, generator=g), torch.randn(64, 16, generator=g)
    exact = a.double() @ b.double()
    err = {p: float((matmul(a, b, p).double() - exact).abs().max())
           for p in ("fp32", "tf32", "fp8")}
    assert err["fp32"] < 1e-4 < err["tf32"] < err["fp8"]
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11])
    assert torch.equal(round_tf32(x), torch.tensor([1.0, 1.0, 1.0 + 2 ** -9]))
    assert round_fp8(torch.ones(2, 2), -1).eq(1).all()


def test_qwen2_prefill_matches_the_port():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_step
    from repro_torch.models.transformer import lm_schema
    from bench.lib import weights as W
    files = tiny.tiny_files("qwen2.prefill_2k")
    cfg = dict(files["config"], torch_dtype="float32")
    spec = PF.lm_spec(cfg)
    params = W.make_params(lm_schema(spec.model, spec.recall,
                                     embed_out=cfg["embed_dim"]),
                           seed=7, dtype=torch.float32, device="cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    step = build_step(spec, ShapeConfig("p", "prefill", 2, 40), device="cpu",
                      pad_to=48).fn
    out = step(params, tokens)
    kv = []
    embs = RQ.prefill(params, tokens, n_layers=cfg["num_hidden_layers"],
                      eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                      exits=RI.exit_layers(cfg["num_hidden_layers"],
                                           cfg["exit_interval"]),
                      on_kv=lambda i, k, v: kv.append((k, v)))
    for i, (k, v) in enumerate(kv):
        assert torch.allclose(out["k_cache"][i, :, :40], k, atol=1e-5)
        assert torch.allclose(out["v_cache"][i, :, :40], v, atol=1e-5)
    assert out["k_cache"][:, :, 40:].abs().max() == 0
    assert torch.allclose(out["exit_embs"], embs, atol=1e-5)
