"""Port parity: the int4 retrieval top-k's plain version (and its CPU
dispatch) against the reference's Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import quantize_int4_np
from repro.kernels.retrieval_topk.kernel import retrieval_topk_int4_pallas
from repro_torch.kernels.retrieval_topk import ops as T
from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_int4_reference

TOL = 1e-5  # fp32 dot products, another summation order


def _bank(Q, N, E, seed):
    rng = np.random.default_rng(seed)
    packed, scales = quantize_int4_np(
        rng.standard_normal((N, E)).astype(np.float32))
    q = rng.standard_normal((Q, E)).astype(np.float32)
    return q, packed, scales


def _assert_topk_close(s_got, i_got, s_want, i_want):
    s_got, s_want = np.asarray(s_got), np.asarray(s_want)
    np.testing.assert_allclose(s_got, s_want, atol=TOL, rtol=0)
    gap = np.full(s_want.shape, np.inf)
    d = np.abs(np.diff(s_want, axis=1))
    gap[:, 1:] = d
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sep = gap > TOL
    sep[:, -1] = False  # the entry after the k-th is unknown
    np.testing.assert_array_equal(np.asarray(i_got)[sep],
                                  np.asarray(i_want)[sep])


CASES = [  # Q, N, E, k, n_valid, normalize
    (5, 200, 32, 10, 200, False),     # N not a multiple of the 64-row block
    (3, 200, 32, 1, 157, False),      # n_valid < N
    (7, 333, 48, 10, 300, True),      # ragged N and n_valid, normalized
    (4, 128, 64, 1, 128, True),
]


@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize", CASES)
def test_plain_matches_pallas_interpret(Q, N, E, k, n_valid, normalize):
    q, packed, scales = _bank(Q, N, E, seed=Q * N)
    s_j, i_j = retrieval_topk_int4_pallas(
        jnp.asarray(q), jnp.asarray(packed), jnp.asarray(scales), k,
        normalize=normalize, block_q=8, block_n=64, interpret=True,
        n_valid=n_valid)
    args = (torch.from_numpy(q), torch.from_numpy(packed),
            torch.from_numpy(scales), k)
    s_t, i_t = retrieval_topk_int4_reference(*args, normalize=normalize,
                                             n_valid=n_valid)
    assert s_t.dtype == torch.float32 and i_t.dtype == torch.int32
    _assert_topk_close(s_t.numpy(), i_t.numpy(), s_j, i_j)
    # streamed in blocks (the merge path) and through the CPU dispatch
    s_b, i_b = retrieval_topk_int4_reference(*args, normalize=normalize,
                                             n_valid=n_valid, block_n=64)
    np.testing.assert_array_equal(s_b.numpy(), s_t.numpy())
    np.testing.assert_array_equal(i_b.numpy(), i_t.numpy())
    before = T.launches
    s_o, i_o = T.retrieval_topk_int4(*args, normalize=normalize,
                                     n_valid=n_valid)
    assert T.launches == before  # the plain version is not a launch
    np.testing.assert_array_equal(s_o.numpy(), s_t.numpy())
    np.testing.assert_array_equal(i_o.numpy(), i_t.numpy())


def test_ties_go_to_lower_id_and_masked_rows_follow():
    """Equal rows score equally: the lower id must win; with n_valid < k the
    masked rows follow in id order at -1e30 (the kernel's contract)."""
    packed = np.tile(quantize_int4_np(np.ones((1, 16), np.float32))[0],
                     (12, 1))
    scales = np.ones((12, 1), np.float32)
    q = torch.ones((2, 16))
    s, i = retrieval_topk_int4_reference(q, torch.from_numpy(packed),
                                         torch.from_numpy(scales), 6,
                                         n_valid=4)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2, 3, 4, 5]] * 2)
    assert np.all(s.numpy()[:, 4:] == -1e30) and np.all(s.numpy()[:, :4] > 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_cuda)
    q, packed, scales = _bank(2, 16, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        retrieval_topk_int4_cuda(torch.from_numpy(q), torch.from_numpy(packed),
                                 torch.from_numpy(scales), 3)
