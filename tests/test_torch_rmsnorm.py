"""Port parity: RMSNorm's plain version against the reference's Pallas
kernel (interpret mode) and its layers.rmsnorm."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro_torch.kernels.rmsnorm import ops as R
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
from repro_torch.models import layers as TL


@pytest.mark.parametrize("shape,block", [((16, 32), 8), ((37, 128), 16),
                                         ((2, 9, 80), 4)])
def test_plain_matches_pallas_and_layers(shape, block):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32) * 3
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want_k = np.asarray(rmsnorm_pallas(jnp.asarray(x), jnp.asarray(s), 1e-6,
                                       block_rows=block, interpret=True))
    want_l = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    got = rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), want_k, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_l, atol=1e-6, rtol=0)
    before = R.launches
    via_layers = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    assert R.launches == before
    np.testing.assert_array_equal(via_layers.numpy(), got.numpy())


def test_bf16_casts_back():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    y = rmsnorm_reference(x.to(torch.bfloat16), torch.ones(32))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               rmsnorm_reference(x, torch.ones(32)).numpy(),
                               atol=2e-2)


def test_triton_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_triton(torch.ones(2, 8), torch.ones(8))
