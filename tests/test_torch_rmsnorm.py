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


@pytest.mark.parametrize("shape,dtype", [((16, 32), "float32"),
                                         ((2, 9, 80), "float32"),
                                         ((37, 128), "bfloat16")])
def test_bwd_plain_matches_jax_grad(shape, dtype):
    """rmsnorm_bwd_reference against jax's autodiff of layers.rmsnorm: dx
    and dscale per element within 1e-5 at max(|g|, 1) in fp32 and one bf16
    step there in bf16 (ref.bwd_limit of flash_attention: the same rule)."""
    import jax
    from repro_torch.kernels.flash_attention.ref import bwd_limit
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_reference
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32) * 3
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, sj, dyj = (jnp.asarray(a, jdt) for a in (x, s, dy))
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm(a, b, 1e-6), xj, sj)
    want = [torch.from_numpy(np.array(g, np.float32)).to(tdt)
            for g in vjp(dyj)]
    xt, st, dyt = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                   for a in (xj, sj, dyj))
    got = rmsnorm_bwd_reference(xt, st, dyt, 1e-6)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        assert ((g.float() - w.float()).abs() <= bwd_limit(w)).all(), \
            (g.float() - w.float()).abs().max()


def test_autograd_on_cpu_takes_the_plain_backward(monkeypatch):
    """Under grad mode rmsnorm_op is the autograd function: on CPU tensors
    its backward is rmsnorm_bwd_reference (no kernel launch), equal to
    autograd through the plain forward; a scale that needs no gradient
    gets none."""
    x = torch.randn(5, 32, generator=torch.Generator().manual_seed(1))
    s = torch.rand(32, generator=torch.Generator().manual_seed(2)) + 0.5
    dy = torch.randn(5, 32, generator=torch.Generator().manual_seed(3))
    calls = []
    real = R.rmsnorm_bwd_reference
    monkeypatch.setattr(R, "rmsnorm_bwd_reference",
                        lambda *a: calls.append(1) or real(*a))
    xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
    before = (R.launches, R.bwd_launches)
    got = torch.autograd.grad(TL.rmsnorm(xg, sg), (xg, sg), dy)
    assert calls == [1] and (R.launches, R.bwd_launches) == before
    xw, sw = x.clone().requires_grad_(), s.clone().requires_grad_()
    want = torch.autograd.grad(rmsnorm_reference(xw, sw), (xw, sw), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)
    xg = x.clone().requires_grad_()
    y = TL.rmsnorm(xg, s)
    (dx,) = torch.autograd.grad(y, (xg,), dy)
    torch.testing.assert_close(dx, got[0])


@pytest.mark.parametrize("D", [64, 80, 1024, 1280, 1536, 2048])
def test_bwd_plan_pieces_tile_the_row(D):
    """The backward's plan: a row's two power-of-two pieces tile D exactly
    (no overlap, no gap, no masked lane) at every width the configs ship,
    and the programs' runs of whole row blocks cover ragged row counts
    once, at most PROGRAMS_PER_SM programs an SM."""
    from repro_torch.kernels.rmsnorm import kernel as K
    (a0, wa), (b0, wb) = K.row_pieces(D)
    assert (a0, b0, wa + wb) == (0, wa, D)
    assert all(w & (w - 1) == 0 for w in (wa, wb))
    for n_rows in (1, 3, 257, 4095, 4096, 8224, 8225):
        for sms in (1, 132):
            plan = K.bwd_plan(n_rows, D, sms)
            assert plan.pieces == K.row_pieces(D)
            assert (plan.block_r, plan.num_warps) == (K.BWD_BLOCK_R,
                                                       K.BWD_WARPS)
            assert plan.rows_per_program % plan.block_r == 0
            assert plan.programs <= K.PROGRAMS_PER_SM * sms
            assert (plan.programs - 1) * plan.rows_per_program < n_rows \
                <= plan.programs * plan.rows_per_program
