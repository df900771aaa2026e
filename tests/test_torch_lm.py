"""Port parity: the LM serving path (configs, schema, RoPE, prefill into a
padded KV cache, greedy decode steps, the step builders) against the
reference, on the smoke variants of qwen2-1.5b and qwen3-moe-30b-a3b with
the reference's params carried across by ``params_from_jax``, fp32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import base as TC
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.moe_gemm import ops as MO
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax

LM_ARCHS = ["qwen2-1.5b", "qwen3-moe-30b-a3b", "minitron-8b", "deepseek-67b",
            "moonshot-v1-16b-a3b"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _same_spec(port, ref):
    assert port.arch_id == ref.arch_id and port.family == ref.family
    assert port.source == ref.source and port.notes == ref.notes
    assert dataclasses.asdict(port.model) == dataclasses.asdict(ref.model)
    assert _fields(port.recall) == _fields(ref.recall)
    assert len(port.shapes) == len(ref.shapes)
    for sp, sr in zip(port.shapes, ref.shapes):
        assert {k: v for k, v in _fields(sp).items()} == \
            {k: getattr(sr, k) for k in _fields(sp)}
    assert port.model.n_params == ref.model.n_params
    assert port.model.n_active_params == ref.model.n_active_params


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_and_smoke_variants_match_reference(arch):
    port, ref = TC.get_arch(arch), JC.get_arch(arch)
    _same_spec(port, ref)
    _same_spec(TC.smoke_variant(port), JC.smoke_variant(ref))
    assert TC.lm_shapes(True) == tuple(
        TC.ShapeConfig(**{k: getattr(s, k) for k in _fields(
            TC.ShapeConfig("x", "y"))}) for s in JC.lm_shapes(True))


def _leaf_shapes(tree, prefix=()):
    if hasattr(tree, "shape") and not isinstance(tree, dict):
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(_leaf_shapes(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("arch,head", [("qwen2-1.5b", "tied"),
                                       ("minitron-8b", "untied"),
                                       ("qwen3-moe-30b-a3b", "moe"),
                                       ("moonshot-v1-16b-a3b", "moe")])
def test_lm_schema_matches_reference(arch, head):
    port = TC.smoke_variant(TC.get_arch(arch))
    ref = JC.smoke_variant(JC.get_arch(arch))
    for kw in ({}, {"with_lm_head": False}, {"embed_out": 48}):
        ours = _leaf_shapes(TT.lm_schema(port.model, port.recall, **kw))
        theirs = _leaf_shapes(JT.lm_schema(ref.model, ref.recall, **kw))
        assert ours == theirs
        assert (("lm_head",) in ours) == (head != "tied" and
                                          "with_lm_head" not in kw)
        assert any(k[:2] == ("layers", "moe") for k in ours) == (head == "moe")


@pytest.mark.parametrize("theta,dtype,tol", [(1e6, np.float32, 1e-5),
                                             (1e4, np.float32, 1e-5),
                                             (1e6, "bfloat16", 1e-2)])
def test_apply_rope_matches_reference(theta, dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), 32760 + np.arange(7)]).astype(np.int32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(JL.apply_rope(xj, jnp.asarray(pos), theta), np.float32)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = TL.apply_rope(xt, torch.from_numpy(pos), theta)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    np.testing.assert_allclose(
        TL.rope_frequencies(16, theta).numpy(),
        np.asarray(JL.rope_frequencies(16, theta)), rtol=1e-6)


def test_embed_lookup_clamps_ids_as_the_reference():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, 3, -2, 9]], np.int32)
    want = np.asarray(JL.embed_lookup(jnp.asarray(table), jnp.asarray(ids)))
    got = TL.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def _close(got, want, what):
    """fp32 through a few random-init layers: 1e-4 of the tensor's scale."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), (what, err)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2-1.5b", "qwen3-moe-30b-a3b"):
        ref = JC.smoke_variant(JC.get_arch(arch))
        port = TC.smoke_variant(TC.get_arch(arch))
        jp = JT.lm_init(jax.random.PRNGKey(0), ref.model, ref.recall)
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
        out[arch] = (ref, port, jp, tp)
    return out


@pytest.mark.parametrize("arch,window", [("qwen2-1.5b", 0),
                                         ("qwen3-moe-30b-a3b", 0),
                                         ("qwen2-1.5b", 4)])
def test_prefill_and_decode_match_reference(models, arch, window):
    ref, port, jp, tp = models[arch]
    B, S, pad_to = 2, 8, 12
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, ref.model.vocab, (B, S)).astype(np.int32)
    j = JT.prefill(jp, ref.model, ref.recall, jnp.asarray(tokens),
                   pad_to=pad_to, window=window)
    t = TT.prefill(tp, port.model, port.recall, torch.from_numpy(tokens),
                   pad_to=pad_to, window=window)
    for key in ("k_cache", "v_cache", "h", "exit_embs", "aux"):
        _close(t[key], j[key], key)
    assert tuple(t["k_cache"].shape) == (4, B, pad_to, 2, 16)
    kj, vj = j["k_cache"], j["v_cache"]
    kt, vt = t["k_cache"], t["v_cache"]
    # per-sequence lengths: the second sequence rewrites prompt positions
    lengths = np.array([S + 1, S - 3], np.int32)
    token = np.asarray(tokens[:, -1])
    before = (DO.launches, MO.launches)
    for step in range(3):
        lj, kj, vj = JT.decode_step(jp, ref.model, ref.recall,
                                    jnp.asarray(token), kj, vj,
                                    jnp.asarray(lengths), window=window)
        lt, kt2, vt2 = TT.decode_step(tp, port.model, port.recall,
                                      torch.from_numpy(token), kt, vt,
                                      torch.from_numpy(lengths),
                                      window=window)
        assert kt2 is kt and vt2 is vt  # written in place
        _close(lt, lj, f"logits step {step}")
        _close(kt, kj, f"k_cache step {step}")
        _close(vt, vj, f"v_cache step {step}")
        assert lt.dtype == torch.float32
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)  # greedy
        lengths = lengths + 1
    assert (DO.launches, MO.launches) == before  # CPU: plain versions only


def test_decode_clamps_the_cache_write_as_the_reference(models):
    ref, port, jp, tp = models["qwen2-1.5b"]
    B, S = 2, 6
    tokens = np.random.default_rng(2).integers(0, 512, (B, S)).astype(
        np.int32)
    j = JT.prefill(jp, ref.model, ref.recall, jnp.asarray(tokens))
    t = TT.prefill(tp, port.model, port.recall, torch.from_numpy(tokens))
    lengths = np.array([S + 3, 0], np.int32)  # past the end; before it
    token = tokens[:, 0]
    lj, kj, _ = JT.decode_step(jp, ref.model, ref.recall, jnp.asarray(token),
                               j["k_cache"], j["v_cache"],
                               jnp.asarray(lengths))
    lt, kt, _ = TT.decode_step(tp, port.model, port.recall,
                               torch.from_numpy(token), t["k_cache"],
                               t["v_cache"], torch.from_numpy(lengths))
    _close(lt, lj, "logits")
    _close(kt, kj, "k_cache")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_build_step_on_cpu(models, arch):
    ref, port, jp, tp = models[arch]
    cfg = port.model
    pre = TS.build_step(port, TC.ShapeConfig("p", "prefill", 2, 8),
                        device="cpu", pad_to=16)
    dec = TS.build_step(port, port.shape("smoke_decode"), device="cpu")
    assert pre.model_flops == 2.0 * cfg.n_active_params * 16
    assert dec.model_flops == (2.0 * cfg.n_active_params * 4
                               + 2.0 * 2 * 4 * 64 * cfg.n_heads * cfg.head_dim)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    out = pre.fn(tp, tokens)
    want = TT.prefill(tp, cfg, port.recall, tokens, pad_to=16)
    assert out["k_cache"].shape == (cfg.n_layers, 2, 16, 2, 16)
    torch.testing.assert_close(out["exit_embs"], want["exit_embs"])
    lengths = torch.tensor([9, 9], dtype=torch.int32)
    token = tokens[:, -1]
    kc, vc = out["k_cache"].clone(), out["v_cache"].clone()
    logits, kc, vc = dec.fn(tp, token, kc, vc, lengths)
    lw, kw, vw = TT.decode_step(tp, cfg, port.recall, token,
                                out["k_cache"].clone(),
                                out["v_cache"].clone(), lengths)
    torch.testing.assert_close(logits, lw)
    torch.testing.assert_close(kc, kw)
    torch.testing.assert_close(vc, vw)
    # the bundle's fp32 head follows an in-place update of the weights
    tp2 = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in tp.items()}
    head = "embed" if cfg.tie_embeddings else "lm_head"
    dec.fn(tp2, token, kc.clone(), vc.clone(), lengths)
    tp2[head].mul_(2.0)
    got = dec.fn(tp2, token, kc.clone(), vc.clone(), lengths)[0]
    want = TT.decode_step(tp2, cfg, port.recall, token, kc.clone(),
                          vc.clone(), lengths)[0]
    torch.testing.assert_close(got, want)
    # the train kind, the mem family and the recsys and gnn families are
    # ported (tests/test_torch_train*, tests/test_torch_families_steps.py);
    # a family the reference does not have raises ValueError, as there
    train = TS.build_step(port, port.shape("smoke_train"), device="cpu")
    assert train.name == "train_step" and train.meta["train"]
    serve = TS.build_step(TC.get_arch("recall-imagebind"),
                          TC.ShapeConfig("e", "serve", 8), device="cpu")
    assert serve.name == "serve_step"
    with pytest.raises(ValueError, match="other"):
        TS.build_step(dataclasses.replace(port, family="other"),
                      port.shape("smoke_train"), device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_forward_hidden_mask_pool_and_kv_match_reference(models, arch):
    """``tokens=`` with a ``mask=`` mean pool and ``return_kv=`` over a
    layer range, against the reference's ``forward_hidden``."""
    ref, port, jp, tp = models[arch]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 512, (3, 10)).astype(np.int32)
    mask = (rng.random((3, 10)) < 0.7).astype(np.float32)
    mask[2] = 0.0  # a row with nothing to pool
    kw = dict(mask=None, collect_pooled=True, return_kv=True, layer_start=1,
              layer_end=3)
    for m in (None, mask):
        kw["mask"] = m
        j = JT.forward_hidden(jp, ref.model, ref.recall,
                              tokens=jnp.asarray(tokens),
                              **{**kw, "mask": None if m is None
                                 else jnp.asarray(m)})
        t = TT.forward_hidden(tp, port.model, port.recall,
                              tokens=torch.from_numpy(tokens),
                              **{**kw, "mask": None if m is None
                                 else torch.from_numpy(m)})
        for key in ("h", "pooled", "aux"):
            _close(t[key], j[key], key)
        _close(t["kv"][0], j["kv"][0], "k")
        _close(t["kv"][1], j["kv"][1], "v")
        assert t["kv"][0].shape[0] == 2


def test_decode_hbm_bytes_matches_reference():
    for arch in LM_ARCHS:
        for B, S, n in ((128, 32768, 1), (32, 2048, 4)):
            assert TS.lm_decode_hbm_bytes(TC.get_arch(arch).model, B, S, n) \
                == JS.lm_decode_hbm_bytes(JC.get_arch(arch).model, B, S, n)


def _lora(ref, seed, scale=0.05):
    """A non-zero LoRA of the reference's schema (numpy): B is not zero, so
    every target's delta shows."""
    from repro.core import plora as JP
    rng = np.random.default_rng(seed)
    return {t: {k: (scale * rng.standard_normal(d.shape)).astype(np.float32)
                for k, d in ab.items()}
            for t, ab in JP.lora_schema(ref.model, ref.recall).items()}


def _close_rel(got, want, what, rel=1e-5):
    """1e-5 of the tensor's scale (max(|want|, 1)): the exit embeddings and
    the logits. Hidden states and caches take ``_close``'s 1e-4, as without
    a LoRA (the random-init residual stream reaches ~75 and the two
    packages part by ~3e-5 of it there with or without one)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), (what, err)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_with_lora_match_reference(models, arch):
    """A non-zero LoRA (all seven targets on the dense model, the four
    attention ones on the MoE) through prefill and three greedy decode
    steps, against the reference: exit embeddings and logits at 1e-5 of
    their scale, hidden states and caches at 1e-4 (``_close_rel``); the
    LoRA moves every output by far more than that."""
    ref, port, jp, tp = models[arch]
    lora = _lora(ref, seed=5)
    jl, tl = jax.tree.map(jnp.asarray, lora), params_from_jax(lora)
    B, S, pad_to = 2, 8, 12
    tokens = np.random.default_rng(6).integers(
        0, ref.model.vocab, (B, S)).astype(np.int32)
    j = JT.prefill(jp, ref.model, ref.recall, jnp.asarray(tokens),
                   pad_to=pad_to, lora=jl)
    j0 = JT.prefill(jp, ref.model, ref.recall, jnp.asarray(tokens),
                    pad_to=pad_to)
    t = TT.prefill(tp, port.model, port.recall, torch.from_numpy(tokens),
                   pad_to=pad_to, lora=tl)
    for key in ("k_cache", "v_cache", "h", "exit_embs"):
        (_close_rel if key == "exit_embs" else _close)(t[key], j[key], key)
        assert np.abs(np.asarray(j[key]) - np.asarray(j0[key])).max() > 1e-3
    kj, vj, kt, vt = j["k_cache"], j["v_cache"], t["k_cache"], t["v_cache"]
    lengths = np.array([S + 1, S - 2], np.int32)
    token = tokens[:, -1]
    for step in range(3):
        lj, kj, vj = JT.decode_step(jp, ref.model, ref.recall,
                                    jnp.asarray(token), kj, vj,
                                    jnp.asarray(lengths), lora=jl)
        lt, kt, vt = TT.decode_step(tp, port.model, port.recall,
                                    torch.from_numpy(token), kt, vt,
                                    torch.from_numpy(lengths), lora=tl)
        _close_rel(lt, lj, f"logits step {step}")
        _close(kt, kj, f"k_cache step {step}")
        _close(vt, vj, f"v_cache step {step}")
        token = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        lengths = lengths + 1


def test_decode_lora_scale_is_the_default_recall_configs(models):
    """The reference's decode_step scales LoRA by the default
    RecallConfig()'s alpha / rank, whatever ``recall`` it is given
    (prefill uses ``recall``'s); the port keeps that (ROADMAP C.4)."""
    import dataclasses
    ref, port, jp, tp = models["qwen2-1.5b"]
    lora = params_from_jax(_lora(ref, seed=7))
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, ref.model.vocab, (2, 6)).astype(np.int32))
    pre = TT.prefill(tp, port.model, port.recall, tokens, pad_to=8)
    lengths = torch.tensor([7, 7], dtype=torch.int32)
    rank4 = dataclasses.replace(port.recall, lora_rank=4)  # alpha/rank 4
    outs = [TT.decode_step(tp, port.model, rc, tokens[:, -1],
                           pre["k_cache"].clone(), pre["v_cache"].clone(),
                           lengths, lora=lora)[0]
            for rc in (port.recall, rank4)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    jrank4 = dataclasses.replace(ref.recall, lora_rank=4)
    jpre = JT.prefill(jp, ref.model, ref.recall, jnp.asarray(tokens.numpy()),
                      pad_to=8)
    lj, _, _ = JT.decode_step(jp, ref.model, jrank4,
                              jnp.asarray(tokens[:, -1].numpy()),
                              jpre["k_cache"], jpre["v_cache"],
                              jnp.asarray(lengths.numpy()),
                              lora=jax.tree.map(jnp.asarray,
                                                _lora(ref, seed=7)))
    _close_rel(outs[1], lj, "logits")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_forward_hidden_with_lora_over_a_layer_range(models, arch):
    """The stacked LoRA is sliced with the layers ([1, 3) here), as the
    reference's slice_layers does."""
    ref, port, jp, tp = models[arch]
    lora = _lora(ref, seed=9)
    tokens = np.random.default_rng(10).integers(0, 512, (3, 7)).astype(
        np.int32)
    kw = dict(collect_pooled=True, layer_start=1, layer_end=3)
    j = JT.forward_hidden(jp, ref.model, ref.recall,
                          tokens=jnp.asarray(tokens),
                          lora=jax.tree.map(jnp.asarray, lora), **kw)
    t = TT.forward_hidden(tp, port.model, port.recall,
                          tokens=torch.from_numpy(tokens),
                          lora=params_from_jax(lora), **kw)
    for key in ("h", "pooled"):
        _close(t[key], j[key], key)


@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_exit_api_matches_reference(models, arch, with_lora):
    """``encode_exits``, ``encode_at`` at the first and the last exit and
    ``refine_from`` the first exit's cached activations, against the
    reference: embeddings at 1e-5 of their scale, hidden and pooled states
    at 1e-4 (``_close``). (Each call of the reference's compiles anew;
    every exit is held to the full pass below, on the port.)"""
    ref, port, jp, tp = models[arch]
    lora = _lora(ref, seed=11) if with_lora else None
    jl = None if lora is None else jax.tree.map(jnp.asarray, lora)
    tl = None if lora is None else params_from_jax(lora)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, ref.model.vocab, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.8).astype(np.float32)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    j = JT.encode_exits(jp, ref.model, ref.recall, tokens=jt, mask=jm,
                        lora=jl)
    t = TT.encode_exits(tp, port.model, port.recall, tokens=tt, mask=tm,
                        lora=tl)
    assert tuple(t["exits"]) == tuple(j["exits"])
    _close_rel(t["exit_embs"], j["exit_embs"], "exit_embs")
    for key in ("pooled", "h", "aux"):
        _close(t[key], j[key], key)
    L = port.model.n_layers
    for e in (t["exits"][0], t["exits"][-1]):
        ja = JT.encode_at(jp, ref.model, ref.recall, e, tokens=jt, mask=jm,
                          lora=jl)
        ta = TT.encode_at(tp, port.model, port.recall, e, tokens=tt, mask=tm,
                          lora=tl)
        _close_rel(ta["emb"], ja["emb"], f"encode_at({e}) emb")
        _close(ta["h"], ja["h"], f"encode_at({e}) h")
        _close(ta["pooled_last"], ja["pooled_last"], f"encode_at({e}) pooled")
        if e == L:
            continue
        jr = JT.refine_from(jp, ref.model, ref.recall, ja["h"], start=e,
                            mask=jm, lora=jl)
        tr = TT.refine_from(tp, port.model, port.recall, ta["h"], start=e,
                            mask=tm, lora=tl)
        assert sorted(tr) == sorted(jr) == ["emb", "h"]
        _close_rel(tr["emb"], jr["emb"], f"refine_from({e}) emb")
        _close(tr["h"], jr["h"], f"refine_from({e}) h")


@pytest.mark.parametrize("with_lora", [False, True], ids=["base", "lora"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_exit_api_resumes_the_full_pass_bit_for_bit(models, arch,
                                                    with_lora):
    """Paper §3.4: stopping early at exit e (``encode_at``) gives the full
    pass's layer-e pooled state, and resuming from its cached layer-e
    activations (``refine_from``) the full pass's hidden state, last pooled
    state and full-depth embedding, all bit for bit. The embedding of
    ``encode_at`` runs the exit head over B rows, ``encode_exits``' over
    the stacked n_exits * B rows: held within 1e-6, as the reference's
    test holds it, and the difference measured on this CPU is 0."""
    ref, port, _, tp = models[arch]
    tl = params_from_jax(_lora(ref, seed=13)) if with_lora else None
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, ref.model.vocab, (2, 11)).astype(np.int32))
    cfg, rc = port.model, port.recall
    with torch.no_grad():
        full = TT.encode_exits(tp, cfg, rc, tokens=tokens, lora=tl)
        last = TT.encode_at(tp, cfg, rc, cfg.n_layers, tokens=tokens,
                            lora=tl)
        assert torch.equal(last["h"], full["h"])
        assert torch.equal(last["pooled_last"], full["pooled"][-1])
        for i, e in enumerate(full["exits"]):
            at = TT.encode_at(tp, cfg, rc, e, tokens=tokens, lora=tl)
            assert torch.equal(at["pooled_last"], full["pooled"][e - 1])
            assert (at["emb"] - full["exit_embs"][i]).abs().max() <= 1e-6
            if e == cfg.n_layers:
                continue
            res = TT.refine_from(tp, cfg, rc, at["h"], start=e, lora=tl)
            assert torch.equal(res["h"], full["h"])
            assert torch.equal(res["emb"], last["emb"])
            assert torch.equal(res["emb"], full["exit_embs"][-1])
            pooled = TT.forward_hidden(tp, cfg, rc, embeds=at["h"],
                                       layer_start=e, collect_pooled=True,
                                       lora=tl)["pooled"]
            assert torch.equal(pooled, full["pooled"][e:])
