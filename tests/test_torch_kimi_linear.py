"""kimi-linear-48b-a3b (Kimi Linear's hybrid: KDA layers beside NoPE MLA,
a dense first layer, sigmoid-routed dropless experts with a shared one)
in the port against the benchmark's plain float32 reference
(``bench/reference/kimi_linear.py``) at a tiny size on the CPU: 8 layers
(KDA 1-3, MLA 4, KDA 5-7, MLA 8: two whole periods; layer 1 dense, 2-8
MoE), d 64, 4 KDA heads of 16, MLA at 4 heads, latent 32, nope 16 / rope
8 / v 16, 8 experts top-2 with 1 shared. Also ``kernels/kda/ref.py``'s
chunked form against the token recurrence, and Moonlight's MLA (with
RoPE) held to its pins."""
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from bench.lib import weights as W
from bench.reference import kimi_linear as RK
from repro_torch.configs import base as TC
from repro_torch.kernels.kda import ops as KOPS
from repro_torch.kernels.kda import ref as KREF
from repro_torch.launch.steps import build_step
from repro_torch.models import attention as A
from repro_torch.models.transformer import lm_schema

# float32 on both sides: the recurrence's chunked form and the token loop
# sum in other orders (and the chunk's T = (I + A)^-1 is solved), so they
# agree to float32 rounding scaled by the chunk's products, ~1e-6 of a
# tensor's scale; 8 layers carry it on, so the model is held at 1e-4,
# still far below the 1e-2 that one bf16 rounding anywhere would cost
TOL_KDA = 2e-5
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, dk, dv, a_log, seed=0, init=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(B, S, H, dk, generator=g),
                                      dim=-1)
    k = torch.nn.functional.normalize(torch.randn(B, S, H, dk, generator=g),
                                      dim=-1)
    v = torch.randn(B, S, H, dv, generator=g)
    decay = -math.exp(a_log) * torch.nn.functional.softplus(
        torch.randn(B, S, H, dk, generator=g))
    beta = torch.sigmoid(torch.randn(B, S, H, generator=g))
    s0 = torch.randn(B, H, dk, dv, generator=g) if init else None
    return q, k, v, decay, beta, s0


def close(got, want, what, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1.0), (what, err)


@pytest.mark.parametrize("S,a_log,init", [
    (100, 0.0, False),            # S not a multiple of the chunk
    (37, 0.0, False),             # S under one chunk
    (130, -2.0, True),            # a non-zero initial state
    (150, math.log(16), False),   # strong decay: the exponent guard
    (128, math.log(16), True)])
def test_chunked_form_matches_the_token_recurrence(S, a_log, init):
    """``kda_chunked`` (the kernel's arithmetic) against ``kda_recurrent``
    (the definition): o and the final state. Under A_log = log 16 a
    token's decay reaches e^-100 and Gamma over a chunk passes -1000, so
    an exp(-Gamma) anywhere would overflow to inf."""
    q, k, v, g, beta, s0 = _inputs(2, S, 3, 16, 8, a_log, seed=S,
                                   init=init)
    if a_log > 0:
        assert float(g.sum(1).min()) < -1000
    o1, s1 = KREF.kda_recurrent(q, k, v, g, beta, scale=0.25,
                                initial_state=s0)
    o2, s2 = KREF.kda_chunked(q, k, v, g, beta, scale=0.25,
                              initial_state=s0)
    assert torch.isfinite(o2).all() and torch.isfinite(s2).all()
    close(o2, o1, "o", TOL_KDA)
    close(s2, s1, "state", TOL_KDA)


def test_kda_ops_cpu_path_is_the_plain_chunked_form():
    q, k, v, g, beta, s0 = _inputs(1, 70, 2, 16, 16, 0.0, seed=1, init=True)
    KOPS.reset_counters()
    o, s = KOPS.kda_chunk(q, k, v, g, beta, scale=0.25, initial_state=s0)
    o2, s2 = KREF.kda_chunked(q, k, v, g, beta, scale=0.25,
                              initial_state=s0)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    # the counters count kernel launches, and the CPU path launches none
    assert KOPS.read_counters() == {"launches": 0, "tokens": 0}


def test_chunked_form_splits_at_any_token():
    """The state after S tokens, carried into the next S', gives the state
    and outputs of the S + S' tokens at once (prefill then more)."""
    q, k, v, g, beta, _ = _inputs(1, 150, 2, 16, 16, -1.0, seed=2)
    o, s = KREF.kda_chunked(q, k, v, g, beta, scale=0.25)
    o1, s1 = KREF.kda_chunked(q[:, :90], k[:, :90], v[:, :90], g[:, :90],
                              beta[:, :90], scale=0.25)
    o2, s2 = KREF.kda_chunked(q[:, 90:], k[:, 90:], v[:, 90:], g[:, 90:],
                              beta[:, 90:], scale=0.25, initial_state=s1)
    close(torch.cat([o1, o2], 1), o, "o", TOL_KDA)
    close(s2, s, "state", TOL_KDA)


def tiny_spec():
    spec = TC.get_arch("kimi-linear-48b-a3b")
    sm = TC.smoke_variant(spec).model
    m = dataclasses.replace(
        sm, n_layers=8,
        kda_layers=tuple(i for i in spec.model.kda_layers if i < 8),
        moe=dataclasses.replace(sm.moe, n_experts=8, top_k=2, d_ff_expert=32,
                                n_shared_experts=1))
    return dataclasses.replace(TC.smoke_variant(spec), model=m)


def ref_config(spec) -> dict:
    """The reference's configuration dict (Kimi's HF key names) of a port
    spec."""
    m = spec.model
    return {"num_hidden_layers": m.n_layers, "hidden_size": m.d_model,
            "num_attention_heads": m.n_heads,
            "kv_lora_rank": m.mla.kv_lora_rank,
            "qk_nope_head_dim": m.mla.qk_nope_head_dim,
            "qk_rope_head_dim": m.mla.qk_rope_head_dim,
            "v_head_dim": m.mla.v_head_dim, "rms_norm_eps": m.norm_eps,
            "latent_norm_eps": m.mla.latent_norm_eps,
            "intermediate_size": m.d_ff,
            "first_k_dense_replace": m.first_k_dense,
            "num_experts": m.moe.n_experts,
            "num_experts_per_token": m.moe.top_k,
            "moe_intermediate_size": m.moe.d_ff_expert,
            "num_shared_experts": m.moe.n_shared_experts,
            "routed_scaling_factor": m.router.routed_scaling_factor,
            "moe_renormalize": m.router.norm_topk_prob,
            "linear_attn_config": {
                "kda_layers": [i + 1 for i in m.kda_layers],
                "num_heads": m.kda.n_heads, "head_dim": m.kda.head_dim,
                "short_conv_kernel_size": m.kda.conv_size},
            "kda_gate_rank": m.kda.gate_rank, "kda_norm_eps": m.kda.norm_eps,
            "exit_interval": spec.recall.exit_interval}


def params_of(spec, seed=0):
    return W.make_params(lm_schema(spec.model, spec.recall, embed_out=32),
                         seed=seed, dtype=torch.float32, device="cpu")


def _leaves(schema):
    if hasattr(schema, "shape") and hasattr(schema, "axes"):
        return [schema]
    return [x for k in schema for x in _leaves(schema[k])]


def test_the_registered_arch_is_kimi_linears_published_config():
    spec = TC.get_arch("kimi-linear-48b-a3b")
    m = spec.model
    assert (m.n_layers, m.d_model, m.n_heads, m.d_ff, m.vocab) == \
        (27, 2304, 32, 9216, 163840)
    assert [i + 1 for i in range(27) if i not in m.kda_layers] == \
        [4, 8, 12, 16, 20, 24, 27]
    assert (m.kda.n_heads, m.kda.head_dim, m.kda.conv_size) == (32, 128, 4)
    assert (m.mla.kv_lora_rank, m.mla.qk_nope_head_dim,
            m.mla.qk_rope_head_dim, m.mla.v_head_dim, m.mla.nope) == \
        (512, 128, 64, 128, True)
    assert (m.moe.n_experts, m.moe.top_k, m.moe.d_ff_expert,
            m.moe.n_shared_experts) == (256, 8, 1024, 1)
    assert (m.first_k_dense, m.norm_eps, m.tie_embeddings,
            m.router.routed_scaling_factor) == (1, 1e-5, False, 2.446)
    # 49.1e9 parameters whole (98 GB in bf16), without RECALL's exit head
    n = sum(math.prod(d.shape) for d in _leaves(lm_schema(m, spec.recall)))
    assert n - 2304 * 1024 - 2304 == m.n_params
    assert 49.0e9 < m.n_params < 49.2e9
    # the benchmark's stage: the first 12 layers, 21.28e9 parameters
    cut = dataclasses.replace(m, n_layers=12, kda_layers=tuple(
        i for i in m.kda_layers if i < 12))
    assert len(cut.kda_layers) == 9 and 21.2e9 < cut.n_params < 21.4e9
    assert A.stack_sizes(cut) == {"attn": 3, "kda": 9}
    assert "kimi-linear-48b-a3b" in TC.port_archs()
    assert "kimi-linear-48b-a3b" not in TC.list_archs()


def test_prefill_latent_rows_states_and_exits_match_the_reference():
    spec = tiny_spec()
    params = params_of(spec)
    c = ref_config(spec)
    B, S, pad = 2, 75, 80
    tokens = torch.randint(0, spec.model.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    out = build_step(spec, TC.ShapeConfig("p", "prefill", B, S),
                     device="cpu", pad_to=pad).fn(params, tokens)
    assert list(out) == ["latent_cache", "kda_state", "conv_state",
                         "exit_embs"]
    lat, st = out["latent_cache"], out["kda_state"]
    assert lat.shape == (2, B, pad, 40) and st.shape == (6, B, 4, 16, 16)
    assert not lat[:, :, S:].any()              # zero past the prompt
    r = c["kv_lora_rank"]
    seen = []

    def on_latent(j, ckv, k_pe):
        close(lat[j, :, :S, :r], ckv, f"c_kv {j}")
        close(lat[j, :, :S, r:], k_pe, f"k_pe {j}")
        seen.append(("mla", j))

    def on_state(j, s):
        close(st[j], s, f"state {j}")
        seen.append(("kda", j))

    embs = RK.prefill(params, tokens, c, on_latent=on_latent,
                      on_state=on_state)
    assert seen == [("kda", 0), ("kda", 1), ("kda", 2), ("mla", 0),
                    ("kda", 3), ("kda", 4), ("kda", 5), ("mla", 1)]
    assert out["exit_embs"].shape == embs.shape == (8, B, 32)
    close(out["exit_embs"], embs, "exits")


def test_prefill_then_decode_through_both_caches_matches_full_logits():
    """2 decode steps on seeded tokens after a prefill of 70 (a chunk and
    a ragged one): each step's logits are the reference's full forward
    pass's at that position, through the latent rows, the KDA states and
    the conv tails."""
    spec = tiny_spec()
    params = params_of(spec, seed=3)
    c = ref_config(spec)
    B, S, n = 2, 70, 2
    seq = torch.randint(0, spec.model.vocab, (B, S + n),
                        generator=torch.Generator().manual_seed(2))
    pre = build_step(spec, TC.ShapeConfig("p", "prefill", B, S),
                     device="cpu", pad_to=S + n).fn
    dec = build_step(spec, TC.ShapeConfig("d", "decode", B, S + n),
                     device="cpu").fn
    out = pre(params, seq[:, :S])
    caches = [out[k] for k in A.cache_names(spec.model)]
    got = []
    for i in range(n):
        lengths = torch.full((B,), S + i + 1, dtype=torch.int32)
        logits, *caches = dec(params, seq[:, S + i], *caches, lengths)
        got.append(logits)
    want = RK.logits(params, seq, c)[:, S:]
    close(torch.stack(got, 1), want, "logits")
    # the decode steps left each cache where a prefill of the whole
    # sequence puts it
    full = pre(params, seq)
    for name, cache in zip(A.cache_names(spec.model), caches):
        close(cache, full[name], name)


def test_mla_nope_caches_k_pe_unrotated():
    """Under ``MLAConfig.nope`` the latent cache's k_pe rows are x W_kv_a's
    as projected: no position enters them."""
    spec = tiny_spec()
    m = spec.model
    params = params_of(spec, seed=5)
    x = torch.randn(1, 9, m.d_model,
                    generator=torch.Generator().manual_seed(6))
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    cache = torch.zeros(1, 9, m.mla.latent_dim)
    A.MLA(m).full(p, x, None, window=0, lora=None, lora_scale=0.0,
                  cache=(cache,))
    want = (x.reshape(9, -1) @ p["w_kv_a"])[:, m.mla.kv_lora_rank:]
    close(cache[0, :, m.mla.kv_lora_rank:], want, "k_pe")


def test_moonlights_mla_with_rope_keeps_its_pinned_bits():
    """Moonlight-16B-A3B's MLA (RoPE on) through the seam the hybrid
    widened: its smoke variant's prefill and two decode steps equal the
    pins of ``tests/test_torch_attention_pins.json``."""
    from tests.test_torch_attention import step_digests
    pins = json.loads(Path(__file__).with_name(
        "test_torch_attention_pins.json").read_text())
    assert not TC.get_arch("moonlight-16b-a3b").model.mla.nope
    assert step_digests("moonlight-16b-a3b") == \
        pins["steps"]["moonlight-16b-a3b"]
