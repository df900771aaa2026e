"""Port parity for the int4 activation-cache kernels: the same numpy-seeded
rows through the reference's Pallas quantize / dequantize (interpret mode,
as tests/test_kernels.py runs them), its ``quantize_int4_np``, and the
port's ``kernels.int4_cache.ops`` on CPU tensors (the plain versions).
Tolerance: none against ``quantize_int4_np`` and the jnp versions: every
packed byte, scale and dequantized value is equal. The reference's Pallas
quantize, run interpreted on the CPU, gives scales up to one ulp apart
(XLA turns ``absmax / 7.0`` into a multiply by the reciprocal; the
reference's own kernel test allows rtol 1e-6 there), and such a scale can
flip a tie of ``rint``; so its scales are held to one ulp and its packed
bytes are equal on every row where its scale is the numpy one. Its
dequantize of the same inputs is equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import (dequantize_int4_np, quantize_int4,
                                 quantize_int4_np)
from repro.kernels.int4_cache import ops as jops
from repro_torch.kernels.int4_cache import ops


def _rows(N, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) * 3).astype(np.float32)
    x[0] = 0.0  # all-zero row: the scale clamps to 1e-12
    if D >= 8 and N > 1:
        # absmax 7 -> scale exactly 1: the .5 ties must round half to even
        x[1] = 0.0
        x[1, :8] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -3.5]
    return x


def _check(x_jax, x_torch):
    p_np, s_np = quantize_int4_np(np.asarray(x_jax, np.float32))
    p_x, s_x = (np.asarray(a) for a in quantize_int4(x_jax))
    p_j, s_j = (np.asarray(a) for a in jops.quantize(x_jax, impl="pallas"))
    p_t, s_t = ops.quantize(x_torch)
    assert p_t.dtype == torch.int8 and s_t.dtype == torch.float32
    for want_p, want_s in ((p_np, s_np), (p_x, s_x)):
        assert np.array_equal(p_t.numpy(), want_p)
        assert np.array_equal(s_t.numpy(), want_s)
    np.testing.assert_array_max_ulp(s_t.numpy(), s_j, maxulp=1)
    same = (s_j == s_np).reshape(-1)
    assert same.any()
    assert np.array_equal(p_t.numpy().reshape(len(same), -1)[same],
                          p_j.reshape(len(same), -1)[same])
    d_j = np.asarray(jops.dequantize(jnp.asarray(p_np), jnp.asarray(s_np),
                                     impl="pallas"))
    d_t = ops.dequantize(p_t, s_t)
    assert d_t.dtype == torch.float32
    assert np.array_equal(d_t.numpy(), d_j)
    assert np.array_equal(d_t.numpy(), dequantize_int4_np(p_np, s_np))
    return p_t, s_t


@pytest.mark.parametrize("N,D", [(300, 64), (257, 1280), (5, 2), (1, 64)])
def test_quant_dequant_bit_exact_f32(N, D):
    """N off the reference's 256-row block, D from one pair to the vision
    tower's width."""
    x = _rows(N, D, seed=N + D)
    _check(jnp.asarray(x), torch.from_numpy(x))


def test_quant_bit_exact_bf16_input():
    x = _rows(40, 64, seed=7)
    xb_j = jnp.asarray(x, jnp.bfloat16)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    # both round the same fp32 values to bf16 the same way
    assert np.array_equal(np.asarray(xb_j, np.float32), xb_t.float().numpy())
    _check(xb_j, xb_t)


def test_ties_and_zero_row_values():
    x = _rows(4, 16, seed=3)
    p, s = ops.quantize(torch.from_numpy(x))
    assert s[0].item() == np.float32(1e-12) and s[1].item() == 1.0
    assert torch.equal(p[0], torch.zeros(8, dtype=torch.int8))
    d = ops.dequantize(p, s)
    # rint: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2, -3.5 -> -4
    assert d[1, :8].tolist() == [7, 0, 2, 2, 0, -2, -2, -4]


def test_dequant_bf16_output_and_leading_dims():
    x = _rows(6, 32, seed=11).reshape(2, 3, 32)
    p, s = ops.quantize(torch.from_numpy(x))
    assert p.shape == (2, 3, 16) and s.shape == (2, 3, 1)
    p_np, s_np = quantize_int4_np(x)
    assert np.array_equal(p.numpy(), p_np) and np.array_equal(s.numpy(), s_np)
    got = ops.dequantize(p, s, dtype=torch.bfloat16)
    want = np.asarray(jops.dequantize(jnp.asarray(p_np.reshape(6, 16)),
                                      jnp.asarray(s_np.reshape(6, 1)),
                                      impl="pallas", dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 32)
    assert np.array_equal(got.float().numpy().reshape(6, 32),
                          want.astype(np.float32))


def test_cpu_tensors_take_the_plain_versions():
    before = (ops.launches, ops.launches_dequant)
    p, s = ops.quantize(torch.ones(3, 4))
    ops.dequantize(p, s)
    assert (ops.launches, ops.launches_dequant) == before
    with pytest.raises(ValueError, match="no kernel"):
        ops.quantize(torch.ones(3, 4, device="meta"))


@pytest.mark.parametrize("D,dtype,aligned,path", [
    (1280, torch.float32, True, "registers"),
    (1024, torch.bfloat16, True, "registers"),
    (8, torch.float32, True, "registers"),
    (1536, torch.float32, True, "registers"),
    (3072, torch.bfloat16, True, "registers"),
    (1544, torch.float32, True, "looped"),
    (3080, torch.bfloat16, True, "looped"),
    (10, torch.float32, True, "looped"),
    (1284, torch.bfloat16, True, "looped"),
    (1280, torch.float32, False, "looped")])
def test_quant_path_by_width(D, dtype, aligned, path):
    """The quantize keeps a row in registers (12 16-byte vectors a lane: D
    up to 1536 f32, 3072 bf16) when D is a multiple of 8 and x 16-byte
    aligned, and loops over it twice otherwise; the card's tests hold the
    kernel's own choice to this rule."""
    from repro_torch.kernels.int4_cache import kernel
    assert kernel.quant_path(D, dtype, aligned=aligned) == path
