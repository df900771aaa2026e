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
