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


# -- the gathered (IVF pruned) scan --------------------------------------


def _candidates(rng, Q, L, N, n_live):
    """(Q, L) int32 candidate rows: per query n_live distinct rows of [0, N)
    (some >= n_valid in the callers), the rest -1 padding."""
    ids = np.full((Q, L), -1, np.int32)
    for qi in range(Q):
        m = min(n_live[qi], L)
        ids[qi, :m] = rng.choice(N, m, replace=False)
        rng.shuffle(ids[qi])
    return ids


GATHER_CASES = [  # Q, N, E, L, k, n_valid, live candidates per query
    (5, 300, 32, 64, 10, 300, [64, 40, 10, 3, 0]),   # -1 padding, short rows
    (7, 300, 48, 200, 6, 250, [200] * 7),             # ids >= n_valid
    (3, 100, 32, 4, 10, 100, [4, 2, 4]),              # L < k
    (9, 500, 64, 128, 64, 480, [128] * 9),            # k at its limit
]


@pytest.mark.parametrize("Q,N,E,L,k,n_valid,n_live", GATHER_CASES)
def test_gathered_plain_matches_pallas_interpret(Q, N, E, L, k, n_valid,
                                                 n_live):
    from repro.kernels.retrieval_topk.ops import (
        retrieval_topk_int4_gathered as j_gathered)
    rng = np.random.default_rng(Q * L)
    q, packed, scales = _bank(Q, N, E, seed=L)
    ids = _candidates(rng, Q, L, N, n_live)
    s_j, i_j = j_gathered(jnp.asarray(q), jnp.asarray(packed),
                          jnp.asarray(scales), ids, k, impl="pallas",
                          interpret=True, n_valid=n_valid, block_q=4,
                          block_l=32)
    before = T.launches_gathered
    s_t, i_t = T.retrieval_topk_int4_gathered(
        torch.from_numpy(q), torch.from_numpy(packed),
        torch.from_numpy(scales), torch.from_numpy(ids), k, n_valid=n_valid)
    assert T.launches_gathered == before  # the plain version is not a launch
    assert s_t.dtype == torch.float32 and i_t.dtype == torch.int32
    s_t, i_t = s_t.numpy(), i_t.numpy()
    s_j, i_j = np.array(s_j), np.array(i_j)
    dead = s_j <= -1e29  # the sentinel pair on both sides
    np.testing.assert_array_equal(s_t <= -1e29, dead)
    assert (i_t[dead] == -1).all() and (i_j[dead] == -1).all()
    s_t[dead] = s_j[dead] = 0.0
    _assert_topk_close(s_t, i_t, s_j, i_j)
    live = (ids >= 0) & (ids < n_valid)
    assert np.isin(i_t[~dead], ids[live]).all()


def test_gathered_plain_normalizes_and_streams():
    """normalize=True against the reference's dequant-all oracle (its Pallas
    kernel scans raw products only), and the chunked plain scan equals the
    one-shot one."""
    from repro.kernels.retrieval_topk.ops import (
        retrieval_topk_int4_gathered as j_gathered)
    from repro_torch.kernels.retrieval_topk.ref import (
        retrieval_topk_int4_gathered_reference as plain)
    rng = np.random.default_rng(7)
    q, packed, scales = _bank(6, 400, 32, seed=3)
    ids = _candidates(rng, 6, 96, 400, [96, 50, 96, 7, 96, 96])
    s_j, i_j = j_gathered(jnp.asarray(q), jnp.asarray(packed),
                          jnp.asarray(scales), ids, 8, impl="ref",
                          normalize=True, n_valid=380)
    args = (torch.from_numpy(q), torch.from_numpy(packed),
            torch.from_numpy(scales), torch.from_numpy(ids), 8)
    s_t, i_t = plain(*args, normalize=True, n_valid=380)
    _assert_topk_close(s_t.numpy(), i_t.numpy(), s_j, i_j)
    s_b, i_b = plain(*args, normalize=True, n_valid=380, block_l=16)
    np.testing.assert_array_equal(s_b.numpy(), s_t.numpy())
    np.testing.assert_array_equal(i_b.numpy(), i_t.numpy())


def test_gathered_ties_go_to_lower_id():
    packed = np.tile(quantize_int4_np(np.ones((1, 16), np.float32))[0],
                     (12, 1))
    scales = np.ones((12, 1), np.float32)
    ids = torch.tensor([[9, 3, -1, 7, 11, 0]], dtype=torch.int32)
    s, i = T.retrieval_topk_int4_gathered(
        torch.ones((1, 16)), torch.from_numpy(packed),
        torch.from_numpy(scales), ids, 6, n_valid=10)
    np.testing.assert_array_equal(i.numpy(), [[0, 3, 7, 9, -1, -1]])
    assert np.all(s.numpy()[0, 4:] == -1e30)


def test_union_rows_scan_matches_gathered_rows():
    """The union strategy's gather + exhaustive scan: local indices into the
    candidate set, padded to its pow2 bucket with masked slots."""
    q, packed, scales = _bank(4, 300, 32, seed=11)
    rows = np.random.default_rng(0).choice(300, 37, replace=False)
    s_u, i_u = T.retrieval_topk_int4_rows(
        torch.from_numpy(q), torch.from_numpy(packed),
        torch.from_numpy(scales), rows, 9)
    s_w, i_w = retrieval_topk_int4_reference(
        torch.from_numpy(q), torch.from_numpy(packed[rows]),
        torch.from_numpy(scales[rows]), 9)
    np.testing.assert_array_equal(s_u.numpy(), s_w.numpy())
    np.testing.assert_array_equal(i_u.numpy(), i_w.numpy())


# -- the dense fp32 scan -------------------------------------------------

DENSE_CASES = [  # Q, N, E, k, n_valid, normalize
    (5, 200, 32, 10, 200, False),
    (7, 333, 48, 10, 300, True),      # ragged N and n_valid < N, normalized
    (3, 130, 64, 1, 77, False),
    (4, 128, 32, 64, 128, True),
]


@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize", DENSE_CASES)
def test_dense_plain_matches_pallas_interpret(Q, N, E, k, n_valid, normalize):
    from repro.kernels.retrieval_topk.kernel import retrieval_topk_pallas
    rng = np.random.default_rng(N + k)
    bank = rng.standard_normal((N, E)).astype(np.float32)
    q = rng.standard_normal((Q, E)).astype(np.float32)
    if not normalize:  # unit rows, as the store's embeddings are
        bank /= np.linalg.norm(bank, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    s_j, i_j = retrieval_topk_pallas(jnp.asarray(q), jnp.asarray(bank), k,
                                     normalize=normalize, block_q=8,
                                     block_n=64, interpret=True,
                                     n_valid=n_valid)
    before = T.launches_dense
    s_t, i_t = T.retrieval_topk(torch.from_numpy(q), torch.from_numpy(bank),
                                k, normalize=normalize, n_valid=n_valid)
    assert T.launches_dense == before
    assert s_t.dtype == torch.float32 and i_t.dtype == torch.int32
    _assert_topk_close(s_t.numpy(), i_t.numpy(), s_j, i_j)
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_reference
    s_b, i_b = retrieval_topk_reference(torch.from_numpy(q),
                                        torch.from_numpy(bank), k,
                                        normalize=normalize, n_valid=n_valid,
                                        block_n=64)
    np.testing.assert_array_equal(s_b.numpy(), s_t.numpy())
    np.testing.assert_array_equal(i_b.numpy(), i_t.numpy())


@pytest.mark.parametrize("entry", ["gathered", "dense"])
def test_new_cuda_wrappers_refuse_cpu_tensors(entry):
    from repro_torch.kernels.retrieval_topk import kernel as K
    q, packed, scales = _bank(2, 16, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "gathered":
            K.retrieval_topk_int4_gathered_cuda(
                torch.from_numpy(q), torch.from_numpy(packed),
                torch.from_numpy(scales), torch.zeros((2, 4), dtype=torch.int32),
                3)
        else:
            K.retrieval_topk_cuda(torch.from_numpy(q), torch.randn(16, 8), 3)


@pytest.mark.parametrize("Q,n_valid,n_sm", [
    (192, 1 << 20, 132), (192, (1 << 20) - 12345, 132), (97, 3000, 132),
    (1, 5, 132), (64, 1 << 20, 132), (193, 8200, 114), (37, 50_001, 132)])
def test_exhaustive_scan_grid_is_one_wave(Q, n_valid, n_sm):
    """The exhaustive scans' query tile pads Q least of 64 and 96 rows (the
    C rule), and the chunks are whole 128-row tiles that cover the live rows
    in at most one wave of two blocks an SM, a tile at least per chunk."""
    from repro_torch.kernels.retrieval_topk import kernel as K
    bq = K.query_tile(Q)
    assert bq in (64, 96)
    assert -(-Q // bq) * bq <= -(-Q // (160 - bq)) * (160 - bq)
    rows = K.chunk_rows(Q, n_valid, n_sm)
    assert rows % K.TILE_ROWS == 0 and rows >= K.TILE_ROWS
    n_chunks = max(1, -(-n_valid // rows))
    blocks = -(-Q // bq) * n_chunks
    assert blocks <= max(K.BLOCKS_PER_SM * n_sm, -(-Q // bq))
    # one tile fewer a chunk would need more than one wave
    if rows > K.TILE_ROWS:
        assert -(-Q // bq) * -(-n_valid // (rows - K.TILE_ROWS)) > \
            K.BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("Q,L,E,n_sm", [
    (192, 8192, 1024, 132), (192, 4096, 1024, 132), (64, 8192, 1024, 132),
    (192, 8192, 2048, 132), (1, 5, 1024, 132), (37, 1500, 1024, 132),
    (3, 20, 200, 132), (2, 9000, 1024, 114), (1000, 70_000, 96, 132),
    (5, 1 << 20, 1024, 132)])
def test_gathered_scan_grid_is_one_wave(Q, L, E, n_sm):
    """The gathered scan's blocks cover a query's L candidates in at most
    one wave of ``gather_blocks_per_sm`` blocks (Q blocks where Q alone is
    more), and no more blocks than give every warp a group of 32; the
    blocks an SM follow the kernel's shared memory (three at E <= 1024,
    two at 2048)."""
    from repro_torch.kernels.retrieval_topk import kernel as K
    assert K.gather_blocks_per_sm(1024) == 3
    assert K.gather_blocks_per_sm(2048) == 2
    bps = K.gather_blocks_per_sm(E)
    assert (bps + 1) * (K.gather_smem_bytes(E) + K.SMEM_RESERVED_PER_BLOCK) \
        > K.SMEM_PER_SM >= bps * (K.gather_smem_bytes(E)
                                  + K.SMEM_RESERVED_PER_BLOCK)
    n_blocks = K.gather_blocks(Q, L, E, n_sm)
    assert n_blocks >= 1
    assert Q * n_blocks <= max(bps * n_sm, Q)
    groups = -(-L // 32)
    assert (n_blocks - 1) * K.GATHER_WARPS < groups  # every block has work
    # one block more a query would need more than one wave, or leave a
    # whole block without a group of candidates
    assert Q * (n_blocks + 1) > bps * n_sm or \
        n_blocks * K.GATHER_WARPS * 32 >= L
