"""Port parity: attention forward's plain version against the reference's
Pallas flash kernel (interpret mode) and its materialized oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JO
from repro.kernels.flash_attention.kernel import flash_fwd_pallas
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention.ref import attention_fwd_reference
from test_torch_gpu import FLASH_BWD_CASES


def _jax_pallas_fwd(q, k, v, *, causal, window, q_offset, block):
    """(out (B,Sq,H,D), lse (B,H,Sq)) from the Pallas kernel, laid out and
    padded as ops.flash_attention(impl='pallas') does."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq, bkv = min(block, Sq), min(block, Skv)
    cfg = JO._Cfg(causal=causal, window=window, q_offset=q_offset,
                  scale=float(1.0 / np.sqrt(D)), block_q=bq, block_kv=bkv,
                  skv_real=Skv, sq_real=Sq, use_pallas=True,
                  block_skip=False, unroll=False)
    qg = JO._pad_to(jnp.moveaxis(q, 2, 1).reshape(B, KV, G, Sq, D), bq, 3)
    kg = JO._pad_to(jnp.moveaxis(k, 2, 1), bkv, 2)
    vg = JO._pad_to(jnp.moveaxis(v, 2, 1), bkv, 2)
    out, lse = flash_fwd_pallas(cfg, qg, kg, vg, interpret=True)
    out = jnp.moveaxis(out[:, :, :, :Sq].reshape(B, H, Sq, D), 1, 2)
    return np.asarray(out), np.asarray(lse[..., :Sq].reshape(B, H, Sq))


CASES = [  # B, Sq, Skv, H, KV, D, causal, window, q_offset
    (2, 19, 19, 2, 2, 64, False, 0, 0),    # ragged, encoder-style
    (1, 21, 45, 4, 2, 80, False, 0, 0),    # GQA G=2, head dim 80
    (2, 24, 24, 4, 2, 64, True, 0, 0),     # causal
    (1, 33, 33, 2, 1, 80, True, 9, 0),     # sliding window
    (1, 7, 30, 2, 2, 64, True, 0, 23),     # q_offset (chunked prefill)
]


def _qkv(B, Sq, Skv, H, KV, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(dtype),
            rng.standard_normal((B, Skv, KV, D)).astype(dtype),
            rng.standard_normal((B, Skv, KV, D)).astype(dtype))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,qoff", CASES)
def test_plain_matches_pallas_and_ref(B, Sq, Skv, H, KV, D, causal, window,
                                      qoff):
    q, k, v = _qkv(B, Sq, Skv, H, KV, D, seed=Sq * D)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    o_j, l_j = _jax_pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block=16, **kw)
    o_r = np.asarray(JO.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), impl="ref", **kw))
    o_t, l_t = attention_fwd_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), **kw)
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o_t.numpy(), o_r, atol=1e-5, rtol=0)
    before = FO.launches
    o_o = FO.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    assert FO.launches == before
    np.testing.assert_array_equal(o_o.numpy(), o_t.numpy())


def test_bf16_matches_pallas():
    q, k, v = _qkv(2, 17, 17, 2, 2, 64, seed=5)
    bf = jnp.bfloat16
    o_j, l_j = _jax_pallas_fwd(jnp.asarray(q, bf), jnp.asarray(k, bf),
                               jnp.asarray(v, bf), causal=False, window=0,
                               q_offset=0, block=8)
    to_bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    o_t, l_t = attention_fwd_reference(to_bf(q), to_bf(k), to_bf(v),
                                       causal=False)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j, np.float32), atol=2e-2)
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=2e-2)


# the CASES shapes, plus one whose first rows see no key (causal, before
# every key)
P_ROUNDING_CASES = CASES + [(1, 16, 32, 2, 2, 64, True, 0, -8)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,qoff",
                         P_ROUNDING_CASES)
def test_bf16_p_rounding_plain_matches_pallas(B, Sq, Skv, H, KV, D, causal,
                                              window, qoff):
    """The plain variant that rounds P to bf16 as the TPU kernel does
    (against the running max of each key block) holds the Pallas kernel's
    bf16 output per element within bf16_step_limit; with p_dtype=None the
    plain version is today's materialised softmax, bit for bit."""
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         bf16_step_limit)
    q, k, v = _qkv(B, Sq, Skv, H, KV, D, seed=Sq * D + 1)
    bf = jnp.bfloat16
    kw = dict(causal=causal, window=window, q_offset=qoff)
    block = 8
    o_j, l_j = _jax_pallas_fwd(jnp.asarray(q, bf), jnp.asarray(k, bf),
                               jnp.asarray(v, bf), block=block, **kw)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o_t, l_t = attention_fwd_reference(qt, kt, vt, p_dtype=torch.bfloat16,
                                       block_kv=min(block, Skv), **kw)
    assert o_t.dtype == torch.bfloat16
    o_j = torch.from_numpy(np.asarray(o_j, np.float32))
    err = (o_t.float() - o_j).abs()
    assert (err <= bf16_step_limit(o_t)).all(), err.max().item()
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-5, rtol=0)
    keyless = ~attention_mask(Sq, Skv, **kw).any(1)
    if keyless.any():  # the uniform softmax over the Skv keys
        mean_v = vt.float().mean(1).repeat_interleave(H // KV, dim=1)
        got = o_t[:, keyless].float()
        assert ((got - mean_v[:, None]).abs()
                <= bf16_step_limit(mean_v[:, None])).all()
    # p_dtype=None: the materialised softmax, as before the variant existed
    o_n, l_n = attention_fwd_reference(qt, kt, vt, p_dtype=None, **kw)
    G = H // KV
    s = torch.einsum("bqkgd,bjkd->bkgqj",
                     qt.reshape(B, Sq, KV, G, D).float(), kt.float())
    s = s * (1.0 / np.sqrt(D))
    s = torch.where(attention_mask(Sq, Skv, **kw), s,
                    torch.full_like(s, -1e30))
    o_old = torch.einsum("bkgqj,bjkd->bqkgd", torch.softmax(s, dim=-1),
                         vt.float()).reshape(B, Sq, H, D).to(torch.bfloat16)
    assert torch.equal(o_n, o_old)
    assert torch.equal(l_n, torch.logsumexp(s, dim=-1).reshape(B, H, Sq))


def test_cuda_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 4, 2, 2, 64, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, k, v, causal=False)


def _window(kind, bk):
    return {"none": 0, "below_tile": bk // 2 - 3, "spans_tiles": 2 * bk + 7}[
        kind]


def _q_offset(kind, bk):
    return {"negative": -bk - 5, "zero": 0, "positive": bk + 3}[kind]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window_kind", ["none", "below_tile", "spans_tiles"])
@pytest.mark.parametrize("q_offset_kind", ["negative", "zero", "positive"])
def test_kv_tile_range_is_the_reference_live_set(dtype, causal, window_kind,
                                                 q_offset_kind):
    """Each q tile of the CUDA kernel visits the key tiles where the
    reference's _kv_block_live holds, or every tile when one of its rows
    sees no key; that predicate is the plain version's all-false mask
    rows. Ragged Sq and Skv, and an Skv below one tile."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_mask
    bq, bk = FK.TILES[torch.bfloat16 if dtype == "bf16" else torch.float32]
    window = _window(window_kind, bk)
    q_offset = _q_offset(q_offset_kind, bk)
    for Sq, Skv in ((3 * bq + 5, 4 * bk + 9), (2 * bq - 7, bk - 17)):
        cfg = JO._Cfg(causal=causal, window=window, q_offset=q_offset,
                      scale=1.0, block_q=bq, block_kv=bk, skv_real=Skv,
                      sq_real=Sq, use_pallas=False, block_skip=True,
                      unroll=False)
        nkt = -(-Skv // bk)
        mask = attention_mask(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset)
        for q0 in range(0, Sq, bq):
            live = np.asarray(JO._kv_block_live(cfg, q0,
                                                jnp.arange(nkt) * bk))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            keyless = FK.keyless_row(q0, bq, Sq, Skv, **kw)
            assert keyless == bool((~mask[q0:q0 + bq].any(1)).any())
            lo, hi = FK.kv_tile_range(q0, bq, bk, Sq, Skv, **kw)
            if keyless:
                assert (lo, hi) == (0, nkt)
            else:
                np.testing.assert_array_equal(
                    np.flatnonzero(live), np.arange(lo, hi))


# --------------------------------------------------------------------------
# the backward: attention_bwd_reference (the plain version of the CUDA
# backward kernel, and the CPU path of the autograd function)
# --------------------------------------------------------------------------

BWD_CASES = CASES + [(1, 16, 32, 2, 2, 64, True, 0, -8),   # keyless rows
                     (2, 20, 20, 6, 2, 128, True, 7, 0)]   # GQA 3:1 window


def _jax_grads(q, k, v, do, *, causal, window, q_offset, block=8):
    """dq, dk, dv of the reference's flash_attention(impl='xla') (its
    custom_vjp: the recomputing _bwd_blocked) for the cotangent do."""
    import jax
    f = lambda q_, k_, v_: JO.flash_attention(
        q_, k_, v_, causal=causal, window=window, q_offset=q_offset,
        block_q=block, block_kv=block, impl="xla")
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,qoff", BWD_CASES)
def test_bwd_plain_matches_jax_grad(B, Sq, Skv, H, KV, D, causal, window,
                                    qoff):
    """fp32, per element within ref.bwd_limit (1e-5 at max(|g|, 1)); a row
    that sees no key passes no gradient to q."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, attention_mask, bwd_limit)
    q, k, v = _qkv(B, Sq, Skv, H, KV, D, seed=Sq * D + 7)
    do = np.random.default_rng(Sq).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    want = _jax_grads(q, k, v, do, **kw)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = attention_fwd_reference(qt, kt, vt, **kw)
    got = attention_bwd_reference(qt, kt, vt, out, lse, dot, **kw)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert ((g - w).abs() <= bwd_limit(w)).all(), (g - w).abs().max()
    keyless = ~attention_mask(Sq, Skv, **kw).any(1)
    if keyless.any():
        assert (got[0][:, keyless] == 0).all()


@pytest.mark.parametrize("causal,window,qoff", [(False, 0, 0), (True, 0, 0),
                                                (True, 5, 3)])
def test_bwd_plain_bf16_rounds_as_the_reference(causal, window, qoff):
    """bf16: the same (out, lse, dout) through the reference's _bwd_blocked
    and the plain version, which rounds P, dS and dO where it does; per
    element within one bf16 step at max(|g|, 1)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, bwd_limit)
    B, S, H, KV, D = 2, 24, 4, 2, 64
    q, k, v = _qkv(B, S, S, H, KV, D, seed=11)
    do = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    bf = jnp.bfloat16
    kw = dict(causal=causal, window=window, q_offset=qoff)
    qt, kt, vt, dot = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    out, lse = attention_fwd_reference(qt, kt, vt, **kw)
    G = H // KV
    cfg = JO._Cfg(scale=float(1.0 / np.sqrt(D)), block_q=8, block_kv=8,
                  skv_real=S, sq_real=S, use_pallas=False, block_skip=False,
                  unroll=False, **kw)
    grouped = lambda x, n: jnp.moveaxis(
        jnp.asarray(x.float().numpy(), bf), 2, 1).reshape(B, n, -1, S, D)
    jq, jo, jdo = (grouped(x, KV) for x in (qt, out, dot))
    jk, jv = (jnp.moveaxis(jnp.asarray(x.float().numpy(), bf), 2, 1)
              for x in (kt, vt))
    jlse = jnp.asarray(lse.numpy()).reshape(B, KV, G, S)
    dq, dk, dv = JO._bwd_blocked(cfg, jq, jk, jv, jo, jlse, jdo)
    want = (np.asarray(jnp.moveaxis(dq.reshape(B, H, S, D), 1, 2),
                       np.float32),
            np.asarray(jnp.moveaxis(dk, 1, 2), np.float32),
            np.asarray(jnp.moveaxis(dv, 1, 2), np.float32))
    got = attention_bwd_reference(qt, kt, vt, out, lse, dot, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = torch.from_numpy(w).to(torch.bfloat16)
        assert ((g.float() - w.float()).abs() <= bwd_limit(w)).all()


def test_autograd_on_cpu_takes_the_plain_backward(monkeypatch):
    """Under grad mode flash_attention is the autograd function: its
    backward on CPU tensors is attention_bwd_reference (no kernel launch),
    and its gradients are autograd's own through the plain forward."""
    from repro_torch.kernels.flash_attention import ref as R
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(2, 9, 9, 4, 2, 64, seed=3))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    calls = []
    real = FO.attention_bwd_reference
    monkeypatch.setattr(FO, "attention_bwd_reference",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    before = (FO.launches, FO.bwd_launches)
    got = torch.autograd.grad(FO.flash_attention(q, k, v, causal=True),
                              (q, k, v), do)
    assert calls == [1] and (FO.launches, FO.bwd_launches) == before
    want = torch.autograd.grad(R.attention_reference(q, k, v, causal=True),
                               (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window_kind", ["none", "below_tile", "spans_tiles"])
@pytest.mark.parametrize("q_offset_kind", ["negative", "zero", "positive"])
def test_tiles_meet_covers_every_visible_pair(causal, window_kind,
                                              q_offset_kind):
    """The backward kernels' tile-pair test (csrc/flash_bwd.cu::tiles_meet)
    holds wherever a (q, key) pair of the two tiles is visible; 64-row
    tiles, ragged Sq and Skv."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_mask
    bt = 64
    window = _window(window_kind, bt)
    q_offset = _q_offset(q_offset_kind, bt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for Sq, Skv in ((3 * bt + 5, 4 * bt + 9), (2 * bt - 7, bt - 17)):
        mask = attention_mask(Sq, Skv, **kw)
        skipped = 0
        for q0 in range(0, Sq, bt):
            for k0 in range(0, Skv, bt):
                seen = bool(mask[q0:q0 + bt, k0:k0 + bt].any())
                meet = FK.tiles_meet(q0, bt, k0, bt, Sq, **kw)
                assert meet or not seen, (q0, k0)
                skipped += not meet
        if causal and q_offset <= 0 and Sq > bt and Skv > bt:
            assert skipped > 0  # the causal corner is skipped


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window_kind", ["none", "below_tile", "spans_tiles"])
@pytest.mark.parametrize("q_offset_kind", ["negative", "zero", "positive"])
def test_needs_mask_holds_only_where_every_pair_is_visible(
        causal, window_kind, q_offset_kind):
    """The bf16 backward's test (csrc/flash_bwd.cu::needs_mask): a 64 x 64
    tile pair it lets through unmasked lies inside Sq and Skv with every
    (q, key) pair visible, and the tiles wholly inside the causal corner
    are let through; ragged Sq and Skv."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_mask
    bt = 64
    window = _window(window_kind, bt)
    q_offset = _q_offset(q_offset_kind, bt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for Sq, Skv in ((5 * bt + 5, 5 * bt + 9), (2 * bt - 7, bt - 17)):
        mask = attention_mask(Sq, Skv, **kw)
        unmasked = 0
        for q0 in range(0, Sq, bt):
            for k0 in range(0, Skv, bt):
                if not FK.needs_mask(q0, bt, k0, bt, Sq, Skv, **kw):
                    assert q0 + bt <= Sq and k0 + bt <= Skv
                    assert bool(mask[q0:q0 + bt, k0:k0 + bt].all()), (q0, k0)
                    unmasked += 1
        if window_kind == "none" and q_offset >= 0 and Sq > 4 * bt:
            assert unmasked > 0  # whole tiles skip the element mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_reduce_head_partials_is_the_gqa_gradient(dtype, causal):
    """The GQA dK/dV split: per-query-head fp32 partials (the plain backward
    with each kv head repeated over its group, in fp32) summed over the
    group in head order by reduce_head_partials (the plain mirror of
    csrc/flash_bwd.cu::reduce_heads) are the plain backward's dk and dv at
    G = 6 (H 12, KV 2), per element within ref.bwd_limit."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, bwd_limit)
    B, S, H, KV, D = 2, 37, 12, 2, 64
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(B, S, S, H, KV, D, seed=61))
    do = torch.from_numpy(np.random.default_rng(62).standard_normal(
        q.shape).astype(np.float32)).to(dtype)
    kw = dict(causal=causal, window=0, q_offset=0)
    out, lse = attention_fwd_reference(q, k, v, **kw)
    _, dk, dv = attention_bwd_reference(q, k, v, out, lse, do, **kw)
    rep = lambda x: x.float().repeat_interleave(H // KV, dim=2)
    _, dk_h, dv_h = attention_bwd_reference(q, rep(k), rep(v), out, lse, do,
                                            **kw)
    assert dk_h.dtype == torch.float32 and dk_h.shape == (B, S, H, D)
    for part, want in ((dk_h, dk), (dv_h, dv)):
        got = FK.reduce_head_partials(part, KV, dtype)
        assert got.dtype == dtype and got.shape == want.shape
        order = part[:, :, 0::6]
        for g in range(1, 6):
            order = order + part[:, :, g::6]
        assert torch.equal(got, order.to(dtype))  # heads kvh G + g, in order
        w = want.float() if dtype == torch.float32 else want
        assert ((got.float() - want.float()).abs() <= bwd_limit(w)).all()


@pytest.mark.parametrize("causal,window,qoff", [(False, 0, 0), (True, 0, 0),
                                                (True, 0, 40), (False, 50, 0),
                                                (True, 30, -20)])
def test_sum_key_tile_partials_is_the_f32_dq(causal, window, qoff):
    """The f32 backward's one-pass dQ: each 64-key tile's fp32 share (the
    plain backward over that tile's keys, positions shifted by q_offset)
    summed in key-tile order by sum_key_tile_partials (the plain mirror of
    csrc/flash_bwd.cu::sum_key_tiles) is the plain backward's dq, per
    element within ref.bwd_limit; the shares of the (q tile, key tile)
    pairs that tiles_meet rules out, which the kernel never writes, are 0.
    Sq 70, Skv 130: three key tiles, the last of 2 keys."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, bwd_limit)
    B, Sq, Skv, H, KV, D, bt = 2, 70, 130, 4, 2, 64, FK.BWD_KEY_TILE
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, Sq, Skv, H, KV, D,
                                                 seed=71))
    do = torch.from_numpy(np.random.default_rng(72).standard_normal(
        q.shape).astype(np.float32))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    out, lse = attention_fwd_reference(q, k, v, **kw)
    dq = attention_bwd_reference(q, k, v, out, lse, do, **kw)[0]
    shares = []
    for k0 in range(0, Skv, bt):
        share = attention_bwd_reference(
            q, k[:, k0:k0 + bt], v[:, k0:k0 + bt], out, lse, do,
            causal=causal, window=window, q_offset=qoff - k0)[0]
        for q0 in range(0, Sq, bt):
            if not FK.tiles_meet(q0, bt, k0, bt, Sq, **kw):
                assert (share[:, q0:q0 + bt] == 0).all(), (q0, k0)
        shares.append(share)
    part = torch.stack(shares, 1)
    assert part.shape == (B, -(-Skv // bt), Sq, H, D)
    got = FK.sum_key_tile_partials(part, torch.float32)
    order = part[:, 0]
    for t in range(1, part.shape[1]):
        order = order + part[:, t]
    assert torch.equal(got, order)  # key tiles 0 .. n_kt - 1, in order
    assert ((got - dq).abs() <= bwd_limit(dq)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,qoff",
                         FLASH_BWD_CASES)
def test_rel_gate_admits_another_summation_order(B, Sq, Skv, H, KV, D,
                                                 causal, window, qoff,
                                                 dtype):
    """The float64-relative gate's floor (the median |g64| of the nonzero
    elements) and multiple (REL_MULTIPLE = 4) at the card tests' cases: a
    plain backward whose sums over D run in another order (the head dim
    permuted) stays within the multiple of the plain version's
    ref.bwd_rel_err (bf16: about 2^-8, the final rounding, where no
    rounding flip of P or dS lands near 0). A smaller floor lets those
    flips dominate the statistic."""
    from repro_torch.kernels.flash_attention.ref import (
        REL_MULTIPLE, attention_bwd_reference, bwd_rel_err)
    rng = np.random.default_rng(Sq * D + Skv)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype)
        for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D),
                  (B, Sq, H, D)))
    kw = dict(causal=causal, window=window, q_offset=qoff)
    out, lse = attention_fwd_reference(q, k, v, **kw)
    plain = attention_bwd_reference(q, k, v, out, lse, do, **kw)
    g64 = attention_bwd_reference(q, k, v, out, lse, do,
                                  compute_dtype=torch.float64,
                                  grad_dtype=torch.float64, **kw)
    perm = torch.from_numpy(rng.permutation(D))
    other = attention_bwd_reference(*(x[..., perm] for x in (q, k, v, out)),
                                    lse, do[..., perm], **kw)
    inv = torch.argsort(perm)
    for name, g, o, w in zip(("dq", "dk", "dv"), plain, other, g64):
        assert bwd_rel_err(o[..., inv], w) <= REL_MULTIPLE * bwd_rel_err(
            g, w), name


def test_rel_gate_fails_a_dropped_key_tile():
    """The float64-relative gate (ref.bwd_rel_err within REL_MULTIPLE times
    the plain version's) against a bf16 plain backward that drops the last
    key tile (causal, S 65: one 64-key tile and one key): it fails each of
    dq, dk and dv, while ref.bwd_limit (one bf16 step at max(|g|, 1), an
    absolute 2^-7 below |g| = 1) lets the faulty dq and dk through."""
    from repro_torch.kernels.flash_attention.ref import (
        REL_MULTIPLE, attention_bwd_reference, bwd_limit, bwd_rel_err)
    B, S, H, D = 1, 65, 2, 64
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in [(B, S, H, D)] * 4)
    kw = dict(causal=True, window=0, q_offset=0)
    out, lse = attention_fwd_reference(q, k, v, **kw)
    plain = attention_bwd_reference(q, k, v, out, lse, do, **kw)
    g64 = attention_bwd_reference(q, k, v, out, lse, do,
                                  compute_dtype=torch.float64,
                                  grad_dtype=torch.float64, **kw)
    dq, dk, dv = attention_bwd_reference(q, k[:, :64], v[:, :64], out, lse,
                                         do, **kw)
    last = torch.zeros((B, 1, H, D), dtype=torch.bfloat16)
    faulty = (dq, torch.cat([dk, last], 1), torch.cat([dv, last], 1))
    for name, g, bad, w in zip(("dq", "dk", "dv"), plain, faulty, g64):
        assert bwd_rel_err(bad, w) > REL_MULTIPLE * bwd_rel_err(g, w), name
    for g, bad in zip(plain[:2], faulty[:2]):
        assert ((bad.float() - g.float()).abs() <= bwd_limit(g)).all()
