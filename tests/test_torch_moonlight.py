"""moonlight-16b-a3b (DeepSeek-V3's block: MLA, a dense first layer,
sigmoid-routed dropless experts with shared ones) in the port against the
benchmark's plain float32 reference (``bench/reference/moonlight.py``) at
a tiny size on the CPU: 3 layers (1 dense + 2 MoE), d 64, 4 heads, latent
32, nope 16 / rope 8 / v 16, 8 experts top-2 with 1 shared. Float32 on
both sides, so the tolerances are float32 summation-order ones (1e-5 of
a tensor's scale), far below the 1e-2 that a bf16 rounding anywhere would
cost."""
import dataclasses
import math

import pytest
import torch

from bench.lib import weights as W
from bench.reference import moonlight as RM
from repro_torch.configs import base as TC
from repro_torch.kernels.flash_attention import ops as FOPS
from repro_torch.launch.steps import build_step
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import lm_schema

TOL = 1e-5   # of a tensor's largest element: float32 in another order


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec():
    spec = TC.smoke_variant(TC.get_arch("moonlight-16b-a3b"))
    m = spec.model
    return dataclasses.replace(spec, model=dataclasses.replace(
        m, moe=dataclasses.replace(m.moe, n_experts=8, top_k=2,
                                   d_ff_expert=32, n_shared_experts=1)))


def ref_config(spec) -> dict:
    """The reference's configuration dict (HF key names) of a port spec."""
    m = spec.model
    return {"num_hidden_layers": m.n_layers, "hidden_size": m.d_model,
            "num_attention_heads": m.n_heads,
            "kv_lora_rank": m.mla.kv_lora_rank,
            "qk_nope_head_dim": m.mla.qk_nope_head_dim,
            "qk_rope_head_dim": m.mla.qk_rope_head_dim,
            "v_head_dim": m.mla.v_head_dim, "rms_norm_eps": m.norm_eps,
            "rope_theta": m.rope_theta, "intermediate_size": m.d_ff,
            "first_k_dense_replace": m.first_k_dense,
            "n_routed_experts": m.moe.n_experts,
            "num_experts_per_tok": m.moe.top_k,
            "moe_intermediate_size": m.moe.d_ff_expert,
            "n_shared_experts": m.moe.n_shared_experts,
            "routed_scaling_factor": m.router.routed_scaling_factor,
            "norm_topk_prob": m.router.norm_topk_prob,
            "exit_interval": spec.recall.exit_interval}


def params_of(spec, seed=0):
    return W.make_params(lm_schema(spec.model, spec.recall, embed_out=32),
                         seed=seed, dtype=torch.float32, device="cpu")


def close(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL * max(want.abs().max().item(), 1.0), (what, err)


def test_the_registered_arch_is_moonlights_published_config():
    spec = TC.get_arch("moonlight-16b-a3b")
    m = spec.model
    assert (m.n_layers, m.d_model, m.n_heads, m.d_ff, m.vocab) == \
        (27, 2048, 16, 11264, 163840)
    assert (m.mla.kv_lora_rank, m.mla.qk_nope_head_dim,
            m.mla.qk_rope_head_dim, m.mla.v_head_dim) == (512, 128, 64, 128)
    assert (m.moe.n_experts, m.moe.top_k, m.moe.d_ff_expert,
            m.moe.n_shared_experts) == (64, 6, 1408, 2)
    assert (m.first_k_dense, m.rope_theta, m.norm_eps, m.tie_embeddings,
            m.router.routed_scaling_factor) == (1, 5e4, 1e-5, False, 2.446)
    # 15.96e9 parameters, 31.9 GB in bf16 (without RECALL's exit head)
    assert m.n_params == 15_960_110_208
    # a port-only arch: the reference's registry is unchanged
    assert "moonlight-16b-a3b" in TC.port_archs()
    assert "moonlight-16b-a3b" not in TC.list_archs()
    n = sum(math.prod(d.shape) for d in _leaves(lm_schema(m, spec.recall)))
    assert n - 2048 * 1024 - 2048 == m.n_params


def _leaves(schema):
    if hasattr(schema, "shape") and hasattr(schema, "axes"):
        return [schema]
    return [x for k in schema for x in _leaves(schema[k])]


def test_prefill_latent_cache_and_exits_match_the_reference():
    spec = tiny_spec()
    params = params_of(spec)
    c = ref_config(spec)
    B, S, pad = 2, 24, 32
    tokens = torch.randint(0, spec.model.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    out = build_step(spec, TC.ShapeConfig("p", "prefill", B, S),
                     device="cpu", pad_to=pad).fn(params, tokens)
    lat = out["latent_cache"]
    assert lat.shape == (3, B, pad, 40)
    assert not lat[:, :, S:].any()              # zero past the prompt
    r = c["kv_lora_rank"]
    seen = []

    def on_latent(i, ckv, k_pe):
        close(lat[i, :, :S, :r], ckv, f"c_kv {i}")
        close(lat[i, :, :S, r:], k_pe, f"k_pe {i}")
        seen.append(i)

    embs = RM.prefill(params, tokens, c, on_latent=on_latent)
    assert seen == [0, 1, 2]
    assert out["exit_embs"].shape == embs.shape == (3, B, 32)  # exits 1-3
    close(out["exit_embs"], embs, "exits")


def test_prefill_then_decode_through_the_latent_cache_matches_full_logits():
    """4 decode steps on seeded tokens after a prefill: each step's logits
    are the reference's full forward pass's at that position."""
    spec = tiny_spec()
    params = params_of(spec, seed=3)
    c = ref_config(spec)
    B, S, n = 2, 20, 4
    seq = torch.randint(0, spec.model.vocab, (B, S + n),
                        generator=torch.Generator().manual_seed(2))
    pre = build_step(spec, TC.ShapeConfig("p", "prefill", B, S),
                     device="cpu", pad_to=S + n).fn
    dec = build_step(spec, TC.ShapeConfig("d", "decode", B, S + n),
                     device="cpu").fn
    latent = pre(params, seq[:, :S])["latent_cache"]
    got = []
    for i in range(n):
        lengths = torch.full((B,), S + i + 1, dtype=torch.int32)
        logits, latent = dec(params, seq[:, S + i], latent, lengths)
        got.append(logits)
    want = RM.logits(params, seq, c)[:, S:]
    close(torch.stack(got, 1), want, "logits")
    # the decode steps wrote the tokens' latent rows where a prefill of the
    # whole sequence puts them
    full = pre(params, seq)["latent_cache"]
    close(latent, full, "latent rows")


def test_router_bias_chooses_and_the_weights_are_unbiased():
    moe = TC.MoEConfig(n_experts=8, top_k=2, d_ff_expert=8)
    router = TC.RouterConfig(routed_scaling_factor=2.5, norm_topk_prob=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 12, generator=g)
    p = {"router": torch.randn(12, 8, generator=g),
         "bias": torch.zeros(8)}
    p["bias"][5] = 10.0                       # expert 5 always chosen
    top_i, w = MOE.route_sigmoid(p, x, moe, router)
    scores = torch.sigmoid(x @ p["router"])
    assert (top_i[:, 0] == 5).all()
    second = torch.topk(scores.masked_fill(
        torch.arange(8) == 5, -1.0), 1).indices[:, 0]
    assert torch.equal(top_i[:, 1], second)
    chosen = torch.gather(scores, 1, top_i)   # the unbiased scores
    assert torch.allclose(w, 2.5 * chosen / chosen.sum(1, keepdim=True),
                          rtol=1e-6)
    assert torch.allclose(w.sum(1), torch.full((16,), 2.5), rtol=1e-6)
    ref_i, ref_w = RM.route({"router": p["router"][None],
                             "bias": p["bias"][None]}, 0, x,
                            {"num_experts_per_tok": 2, "norm_topk_prob": True,
                             "routed_scaling_factor": 2.5}, "fp32")
    assert torch.equal(top_i, ref_i) and torch.allclose(w, ref_w)


def test_a_batch_routed_all_to_one_expert_drops_nothing():
    """Every token's top-1 is expert 3 (its bias): the dropless layer
    still runs every assignment, where GShard's capacity would drop
    most of them."""
    spec = tiny_spec()
    m = spec.model
    params = params_of(spec, seed=4)
    mp = {k: v[0] for k, v in params["layers"]["moe"].items()
          if not isinstance(v, dict)}
    mp["shared"] = {k: v[0] for k, v in
                    params["layers"]["moe"]["shared"].items()}
    mp["bias"] = torch.zeros(8)
    mp["bias"][3] = 100.0
    x = torch.randn(2, 40, m.d_model, generator=torch.Generator().manual_seed(5))
    MOE.reset_counters()
    y, aux = MOE.moe_apply_dropless(mp, x, m.moe, m.router)
    cnt = MOE.read_counters()
    assert cnt["assignments"] == 80 * 2 and cnt["max_load"] == 80
    assert MOE.capacity(40, m.moe) < 40      # GShard would drop here
    c = ref_config(spec)
    want = RM.moe({k: (v[None] if not isinstance(v, dict) else
                       {kk: vv[None] for kk, vv in v.items()})
                   for k, v in mp.items()}, 0, x.reshape(80, -1), c, "fp32")
    close(y.reshape(80, -1), want, "moe")
    assert float(aux) == 0.0


def test_flash_cpu_path_takes_another_v_head_dim():
    """q/k 24 wide, v 16 (MLA's shape at the tiny size): the plain path's
    out and lse against softmax(q k^T / sqrt(24)) v written out."""
    g = torch.Generator().manual_seed(6)
    B, S, H = 2, 19, 3
    q, k = (torch.randn(B, S, H, 24, generator=g) for _ in range(2))
    v = torch.randn(B, S, H, 16, generator=g)
    out, lse = FOPS.flash_attention_fwd(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(24)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert out.shape == (B, S, H, 16)
    close(out, want, "out")
    close(lse, torch.logsumexp(s, -1), "lse")
