"""Port parity: single-token decode attention's plain version and its CPU
dispatch against the reference's oracle and its Pallas flash-decoding
kernel (interpret mode)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_fwd_pallas
from repro.kernels.decode_attention.ref import (
    decode_attention_reference as jax_reference)
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ops as DO
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference)

CASES = [  # B, S, H, KV, D, window, block_kv, lengths (None = random)
    (2, 256, 8, 2, 32, 0, 64, None),       # the reference's kernel cases
    (3, 100, 4, 4, 16, 0, 32, None),
    (2, 512, 8, 1, 64, 128, 128, None),
    (1, 64, 16, 8, 128, 0, 64, None),
    (3, 96, 6, 1, 128, 0, 32, (1, 96, 50)),  # lengths 1 and S, qwen2's G
    (2, 80, 8, 2, 64, 16, 32, (80, 7)),     # window, length < window
    (2, 40, 4, 4, 32, 0, 32, (0, 41)),      # no valid position; past S
]


def _inputs(B, S, H, KV, D, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("B,S,H,KV,D,window,bkv,lengths", CASES)
def test_plain_and_dispatch_match_reference_and_pallas(B, S, H, KV, D, window,
                                                       bkv, lengths):
    q, k, v, lens = _inputs(B, S, H, KV, D, lengths, seed=S * D + B)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens),
                                    window=window))
    before = DO.launches
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    plain = decode_attention_reference(*t, window=window).numpy()
    got = DO.decode_attention(*t, window=window).numpy()
    assert DO.launches == before  # a CPU tensor launches no kernel
    np.testing.assert_allclose(plain, want, atol=3e-5)
    np.testing.assert_allclose(got, want, atol=3e-5)
    if min(lens) >= 1 and max(lens) <= S:
        # the Pallas kernel pads S to its block and would average the
        # padding into a row with no valid position: compare valid rows
        pal = np.asarray(decode_fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            window=window, block_kv=bkv))
        np.testing.assert_allclose(got, pal, atol=3e-5)


def test_bf16_matches_reference():
    """The reference's own bf16 case: bf16 inputs, fp32 math, bf16 out."""
    rng = np.random.default_rng(1)
    bf = ml_dtypes.bfloat16
    q = rng.standard_normal((2, 4, 32)).astype(bf)
    k = rng.standard_normal((2, 128, 2, 32)).astype(bf)
    v = rng.standard_normal((2, 128, 2, 32)).astype(bf)
    lens = np.array([60, 128], np.int32)
    want = np.asarray(jax_reference(
        jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32),
        jnp.asarray(v, jnp.float32), jnp.asarray(lens)))
    pal = np.asarray(decode_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       block_kv=64), np.float32)
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
         for a in (q, k, v)]
    got = DO.decode_attention(*t, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), pal, atol=3e-2)


@pytest.mark.parametrize("B,KV,S,n_sm", [(32, 2, 32768, 132), (16, 4, 4096, 132),
                                         (1, 1, 10, 132), (128, 8, 64, 132),
                                         (3, 2, 1000, 132), (1, 1, 500, 114)])
def test_split_count(B, KV, S, n_sm):
    """Full waves of pass-1 blocks (``WAVES`` x ``BLOCKS_PER_SM`` an SM),
    no split of a full cache under ``SPLIT_TILES`` 32-key tiles, and no
    split more than the waves need."""
    ns = DK.n_splits(B, KV, S, n_sm)
    slots = DK.WAVES * DK.BLOCKS_PER_SM * n_sm
    cap = -(-S // (DK.SPLIT_TILES * DK.TILE))
    assert 1 <= ns <= cap
    if ns < cap:
        assert B * KV * ns >= slots
    assert ns == 1 or B * KV * (ns - 1) < slots


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, lens = (torch.from_numpy(a) for a in
                     _inputs(1, 8, 2, 1, 16, (3,), seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        DK.decode_attn_cuda(q, k, v, lens)
