"""The port's kernels against their plain versions on a CUDA device, at
small shapes. Marked ``gpu``: they skip where there is no card and run on
the GPU with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``
(the full-shape checks are in ``chip_smoke.py``)."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize", [
    (7, 5000, 256, 10, 4990, False), (3, 300, 96, 64, 300, True),
    (2, 40, 40, 10, 6, False)])
def test_topk_kernel_matches_plain(gen, Q, N, E, k, n_valid, normalize):
    from repro_torch.core.quantize import quantize_int4
    from repro_torch.kernels.retrieval_topk import ops
    from repro_torch.kernels.retrieval_topk.ref import (
        retrieval_topk_int4_reference)
    bank = torch.randn((N, E), generator=gen, device="cuda")
    packed, scales = quantize_int4(bank / bank.norm(dim=1, keepdim=True))
    q = torch.randn((Q, E), generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    before = ops.launches
    s, i = ops.retrieval_topk_int4(q, packed, scales, k, normalize=normalize,
                                   n_valid=n_valid)
    assert ops.launches == before + 1
    s_p, i_p = retrieval_topk_int4_reference(q, packed, scales, k,
                                             normalize=normalize,
                                             n_valid=n_valid)
    assert (s - s_p).abs().max().item() <= 1e-5
    gap = (s_p[:, 1:] - s_p[:, :-1]).abs() > 1e-5
    sep = torch.ones_like(s_p, dtype=torch.bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    sep[:, -1] = False
    assert torch.equal(i[sep], i_p[sep])


@pytest.mark.parametrize("D,dtype,causal,window,q_offset,kv", [
    (64, torch.float32, True, 0, 5, 2), (80, torch.bfloat16, False, 0, 0, 4),
    (128, torch.float32, True, 7, 0, 1)])
def test_flash_kernel_matches_plain(gen, D, dtype, causal, window, q_offset,
                                    kv):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_fwd_reference
    B, Sq, Skv, H = 2, 37, 45, 4
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, kv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, kv, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.launches
    before_d = ops.launches_by_head_dim.get(D, 0)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.launches == before + 1
    assert ops.launches_by_head_dim[D] == before_d + 1
    o_p, lse_p = attention_fwd_reference(q, k, v, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - o_p.float()).abs().max().item() <= tol
    assert (lse - lse_p).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape,dtype", [((33, 1280), torch.bfloat16),
                                         ((5, 7, 64), torch.float32)])
def test_rmsnorm_kernel_matches_plain(gen, shape, dtype):
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    s = torch.rand((shape[-1],), generator=gen, device="cuda").to(dtype) + 0.5
    before = ops.launches
    y = ops.rmsnorm_op(x, s)
    assert ops.launches == before + 1
    y_p = rmsnorm_reference(x, s)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    lim = rel * max(1.0, y_p.float().abs().max().item())
    assert (y.float() - y_p.float()).abs().max().item() <= lim


def _sep(s_p, tol=1e-5):
    gap = (s_p[:, 1:] - s_p[:, :-1]).abs() > tol
    sep = torch.ones_like(s_p, dtype=torch.bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    sep[:, -1] = False
    return sep


@pytest.mark.parametrize("Q,N,E,L,k,n_valid", [
    (7, 5000, 256, 300, 10, 4990), (3, 300, 96, 64, 64, 300),
    (2, 40, 40, 16, 10, 30)])
def test_gathered_kernel_matches_plain(gen, Q, N, E, L, k, n_valid):
    """Gathered scan vs its plain version, with -1 padding, ids >= n_valid
    and rows of fewer than k live ids; every live row's score equals the
    exhaustive kernel's bit for bit."""
    from repro_torch.core.quantize import quantize_int4
    from repro_torch.kernels.retrieval_topk import ops
    from repro_torch.kernels.retrieval_topk.ref import (
        retrieval_topk_int4_gathered_reference)
    bank = torch.randn((N, E), generator=gen, device="cuda")
    packed, scales = quantize_int4(bank / bank.norm(dim=1, keepdim=True))
    q = torch.randn((Q, E), generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    ids = torch.randint(0, N, (Q, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[:, ::5] = -1
    ids[-1, 3:] = -1  # the last query has fewer than k live ids
    before = ops.launches_gathered
    s, i = ops.retrieval_topk_int4_gathered(q, packed, scales, ids, k,
                                            n_valid=n_valid)
    assert ops.launches_gathered == before + 1
    s_p, i_p = retrieval_topk_int4_gathered_reference(q, packed, scales, ids,
                                                      k, n_valid=n_valid)
    assert (s - s_p).abs().max().item() <= 1e-5
    assert torch.equal(i[_sep(s_p)], i_p[_sep(s_p)])
    dead = s_p <= -1e29
    assert torch.equal(s <= -1e29, dead) and (i[dead] == -1).all()
    # one shared candidate set, in id order, through both kernels: the
    # exhaustive scan of the gathered rows returns the same scores, bit for bit
    rows = torch.unique(ids[0][(ids[0] >= 0) & (ids[0] < n_valid)])
    kk = min(k, rows.numel())
    s_g, i_g = ops.retrieval_topk_int4_gathered(
        q, packed, scales, rows.int()[None].expand(Q, -1).contiguous(), kk,
        n_valid=n_valid)
    s_x, i_x = ops.retrieval_topk_int4(q, packed.index_select(0, rows),
                                       scales.index_select(0, rows), kk)
    assert torch.equal(s_g, s_x)
    assert torch.equal(i_g, rows[i_x.long()].int())


@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize", [
    (7, 5000, 256, 10, 4990, False), (3, 300, 96, 64, 300, True),
    (2, 40, 41, 10, 6, False)])
def test_dense_kernel_matches_plain(gen, Q, N, E, k, n_valid, normalize):
    from repro_torch.kernels.retrieval_topk import ops
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_reference
    bank = torch.randn((N, E), generator=gen, device="cuda")
    bank = bank / bank.norm(dim=1, keepdim=True)
    q = torch.randn((Q, E), generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    before = ops.launches_dense
    s, i = ops.retrieval_topk(q, bank, k, normalize=normalize,
                              n_valid=n_valid)
    assert ops.launches_dense == before + 1
    s_p, i_p = retrieval_topk_reference(q, bank, k, normalize=normalize,
                                        n_valid=n_valid)
    assert (s - s_p).abs().max().item() <= 1e-5
    assert torch.equal(i[_sep(s_p)], i_p[_sep(s_p)])
