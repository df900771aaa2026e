"""Port parity: torch int4 quantize/dequantize are bit-exact with the numpy
and jnp versions of the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as RQ
from repro_torch.core import quantize as TQ


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1])  # a view
    rows[0] = 0.0  # all-zero row: scale clamps to 1e-12
    # exact .5 ties at scale 1: round half to even must pick the even side
    rows[1, :8] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    rows[1, 8:] = 0.0
    return x


@pytest.mark.parametrize("shape,seed", [((6, 16), 0), ((9, 64), 1),
                                        ((4, 3, 32), 2)])
def test_quantize_int4_bit_exact(shape, seed):
    x = _inputs(shape, seed)
    p_np, s_np = RQ.quantize_int4_np(x)
    p_j, s_j = RQ.quantize_int4(jnp.asarray(x))
    p_t, s_t = TQ.quantize_int4(torch.from_numpy(x))
    assert p_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(p_t.numpy(), p_np)
    np.testing.assert_array_equal(s_t.numpy(), s_np)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # the port's numpy copy is the reference's, value for value
    p2, s2 = TQ.quantize_int4_np(x)
    np.testing.assert_array_equal(p2, p_np)
    np.testing.assert_array_equal(s2, s_np)


@pytest.mark.parametrize("shape,seed", [((6, 16), 3), ((4, 3, 32), 4)])
def test_dequantize_int4_round_trip(shape, seed):
    x = _inputs(shape, seed)
    p, s = RQ.quantize_int4_np(x)
    want = RQ.dequantize_int4_np(p, s)
    got = TQ.dequantize_int4(torch.from_numpy(p), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TQ.dequantize_int4_np(p, s), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RQ.dequantize_int4(jnp.asarray(p),
                                                   jnp.asarray(s))))
    # ties resolved to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0 ...
    rows = got.numpy().reshape(-1, shape[-1])
    np.testing.assert_array_equal(rows[1, :8], [7, 0, 2, 2, 0, -2, -2, 4])
    assert np.all(rows[0] == 0)
