"""The port's kernels against their plain versions on a CUDA device, at
small shapes. Marked ``gpu``: they skip where there is no card and run on
the GPU with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``
(the full-shape checks are in ``chip_smoke.py``)."""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# the register-blocked int4 tile's edges: E not a multiple of the 32-element
# slice (96, 40, 200; 202 also takes 4-byte query copies), E = 2048, Q not a
# multiple of the 96-row query tile (97), k = 64 with normalize, n_valid < k,
# ragged N and n_valid against the 128-row tile
@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize", [
    (7, 5000, 256, 10, 4990, False), (3, 300, 96, 64, 300, True),
    (2, 40, 40, 10, 6, False), (5, 3000, 200, 10, 3000, False),
    (4, 5000, 2048, 10, 4999, True), (97, 3000, 1024, 10, 2990, False),
    (6, 2000, 256, 64, 2000, True), (3, 300, 64, 10, 7, True),
    (3, 700, 202, 10, 650, True)])
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


# f32 cases cover the FMA kernel's edges: the vision shape at small B
# (S 257 = 4 * 64 + 1, D 80), causal with q_offset at D 64 and 128, a
# window, GQA, and rows that see no key (before every key, past every
# window); bf16 runs the wgmma kernel
@pytest.mark.parametrize("B,Sq,Skv,H,kv,D,dtype,causal,window,q_offset", [
    (2, 37, 45, 4, 2, 64, torch.float32, True, 0, 5),
    (2, 37, 45, 4, 4, 80, torch.bfloat16, False, 0, 0),
    (2, 37, 45, 4, 1, 128, torch.float32, True, 7, 0),
    (2, 257, 257, 4, 4, 80, torch.float32, False, 0, 0),
    (2, 100, 130, 6, 2, 64, torch.float32, True, 0, 30),
    (1, 70, 200, 4, 1, 128, torch.float32, True, 0, 129),
    (2, 150, 150, 4, 2, 80, torch.float32, False, 33, 0),
    (1, 64, 40, 2, 2, 64, torch.float32, True, 0, -30),
    (1, 200, 50, 2, 2, 80, torch.float32, False, 5, 60)])
def test_flash_kernel_matches_plain(gen, B, Sq, Skv, H, kv, D, dtype, causal,
                                    window, q_offset):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import plain_like_kernel
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         bf16_step_limit)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, kv, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, kv, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.launches
    before_d = ops.launches_by_head_dim.get(D, 0)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.launches == before + 1
    assert ops.launches_by_head_dim[D] == before_d + 1
    o_p, lse_p = plain_like_kernel(q, k, v, **kw)
    err = (o.float() - o_p.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err <= bf16_step_limit(o_p)).all()
    assert (lse - lse_p).abs().max().item() <= 1e-4
    keyless = ~attention_mask(Sq, Skv, **kw).any(1)
    if keyless.any():  # the reference's uniform softmax over the Skv keys
        mean_v = v.float().mean(1).repeat_interleave(H // kv, dim=1)
        assert (o[:, keyless].float() - mean_v[:, None]).abs().max() <= 1e-5


# bf16 side cases of the wgmma kernel (128-row q tiles, 128-key tiles):
# causal with q_offset, windows below and above the tile, ragged Sq and Skv,
# Skv below one tile, rows that see no key, GQA 6:1 and 8:1, D 64/80/128
FLASH_BF16_CASES = [  # B, Sq, Skv, H, KV, D, causal, window, q_offset
    (2, 77, 130, 12, 2, 128, True, 0, 53),
    (2, 300, 300, 32, 4, 128, True, 0, 0),
    (3, 100, 300, 6, 1, 128, True, 17, 0),
    (2, 300, 300, 8, 1, 128, True, 200, 0),
    (2, 33, 257, 6, 3, 80, False, 0, 0),
    (2, 78, 78, 16, 16, 64, False, 0, 0),
    (1, 64, 40, 2, 2, 64, True, 0, -30),     # rows before every key
    (1, 200, 50, 2, 2, 64, False, 5, 60),    # windows past every key
    (2, 150, 90, 4, 2, 80, True, 40, 70)]    # both, in a mixed tile


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,q_offset",
                         FLASH_BF16_CASES)
def test_flash_bf16_side_cases_match_plain(gen, B, Sq, Skv, H, KV, D, causal,
                                           window, q_offset):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import plain_like_kernel
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         bf16_step_limit)
    bf = torch.bfloat16
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(bf)
    k = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(bf)
    v = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(bf)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    # the plain variant that rounds P to bf16 as the kernel does, per
    # element within one bf16 step at max(|o|, 1) (ref.bf16_step_limit)
    o_p, lse_p = plain_like_kernel(q, k, v, **kw)
    assert ((o.float() - o_p.float()).abs() <= bf16_step_limit(o_p)).all()
    assert (lse - lse_p).abs().max().item() <= 1e-4
    keyless = ~attention_mask(Sq, Skv, **kw).any(1)
    if keyless.any():  # the reference's uniform softmax over the Skv keys
        mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)[:, None]
        got = o[:, keyless].float()
        assert ((got - mean_v).abs() <= bf16_step_limit(mean_v)).all()


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


# the gathered pass 1's paths: 16-byte rows in whole slices (256, 1024) and
# a partial slice (96: three chunks), the byte path (E/2 % 16 != 0: 40,
# 200), L below one warp's 32 on both (16, 20), many blocks of a query
# (L = 9000, 3000 at small Q), E = 2048 (two blocks an SM), a query whose
# every candidate is dead, and query elements that are subnormal or tiny
@pytest.mark.parametrize("Q,N,E,L,k,n_valid,dead_query,tiny", [
    (7, 5000, 256, 300, 10, 4990, False, False),
    (3, 300, 96, 64, 64, 300, False, False),
    (2, 40, 40, 16, 10, 30, False, False),
    (3, 500, 256, 20, 10, 500, True, False),
    (4, 3000, 200, 700, 16, 2999, True, False),
    (2, 20000, 1024, 9000, 10, 20000, False, True),
    (5, 30000, 1024, 3000, 10, 29000, True, False),
    (3, 4000, 2048, 700, 16, 4000, False, True)])
def test_gathered_kernel_matches_plain(gen, Q, N, E, L, k, n_valid,
                                       dead_query, tiny):
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
    if tiny:  # subnormal (1e-39 .. 1e-45) and tiny (1e-30) query elements
        q[:, 1::4] *= 1e-39
        q[:, 2::8] = 1e-45
        q[:, 3::16] *= 1e-30
    ids = torch.randint(0, N, (Q, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[:, ::5] = -1
    ids[-1, 3:] = -1  # the last query has fewer than k live ids
    if dead_query:
        ids[1] = -1  # query 1 has no live id
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


# Q not a multiple of the query tile (1, 193), N and n_valid off the
# 128-row tile, n_valid < k, E of 1, 41, 201 and 2048, normalize on and
# off; ``ties`` makes 18 rows equal to query 0 across tile boundaries
# (250..255, 4090..4101; chunks are whole tiles): its top 10 must be the
# lowest ids
@pytest.mark.parametrize("Q,N,E,k,n_valid,normalize,ties", [
    (7, 5000, 256, 10, 4990, False, False),
    (3, 300, 96, 64, 300, True, False),
    (2, 40, 41, 10, 6, False, False),
    (1, 4500, 1024, 10, 4321, True, False),
    (193, 5000, 201, 16, 4999, False, False),
    (5, 700, 1, 3, 650, True, False),
    (9, 1000, 2048, 10, 1000, True, False),
    (4, 9000, 41, 10, 8999, False, True),
    (192, 8200, 1024, 10, 8200, True, True)])
def test_dense_kernel_matches_plain(gen, Q, N, E, k, n_valid, normalize,
                                    ties):
    from repro_torch.kernels.retrieval_topk import ops
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_reference
    bank = torch.randn((N, E), generator=gen, device="cuda")
    bank = bank / bank.norm(dim=1, keepdim=True)
    q = torch.randn((Q, E), generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    tied = torch.cat([torch.arange(250, 256), torch.arange(4090, 4102)])
    if ties:
        bank[tied] = q[0]
    before = ops.launches_dense
    s, i = ops.retrieval_topk(q, bank, k, normalize=normalize,
                              n_valid=n_valid)
    assert ops.launches_dense == before + 1
    s_p, i_p = retrieval_topk_reference(q, bank, k, normalize=normalize,
                                        n_valid=n_valid)
    assert (s - s_p).abs().max().item() <= 1e-5
    assert torch.equal(i[_sep(s_p)], i_p[_sep(s_p)])
    if ties:
        assert torch.equal(i[0].cpu(), tied[:k].int())
        assert (s[0] == s[0, 0]).all()


def _int4_rows(gen, N, D, dtype):
    x = (torch.randn((N, D), generator=gen, device="cuda") * 3).to(dtype)
    x[0] = 0  # all-zero row: the scale clamps to 1e-12
    if N > 1 and D >= 8:  # absmax 7, scale exactly 1: ties to even
        x[1] = 0
        x[1, :8] = torch.tensor([7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -3.5])
    return x


# the quantize's register path: N off the 8 rows a block (300, 257, 13),
# more rows than one wave of warps holds (5000: each warp walks rows two at
# a time, an odd count on some), a partial pair of 128-element blocks (1032
# f32), the widest rows (1536 f32, 3072 bf16); its looped path: D % 8 != 0
# (2, 10), rows wider than the registers hold (1544 f32, 3080 bf16), x not
# 16-byte aligned (offset)
@pytest.mark.parametrize("N,D,dtype,offset", [
    (300, 1280, torch.float32, 0), (257, 64, torch.bfloat16, 0),
    (1, 2, torch.float32, 0), (33, 10, torch.float32, 0),
    (13, 1280, torch.bfloat16, 0), (5000, 136, torch.float32, 0),
    (7, 1032, torch.float32, 0), (9, 1536, torch.float32, 0),
    (11, 3072, torch.bfloat16, 0), (9, 1544, torch.float32, 0),
    (5, 3080, torch.bfloat16, 0), (6, 1280, torch.float32, 2),
    (5, 64, torch.bfloat16, 4)])
def test_int4_cache_kernels_match_plain_bit_for_bit(gen, N, D, dtype, offset):
    import numpy as np
    from repro_torch.core.quantize import quantize_int4_np
    from repro_torch.kernels.int4_cache import kernel, ops
    from repro_torch.kernels.int4_cache.ref import (
        dequantize_int4_reference, quantize_int4_reference)
    x = _int4_rows(gen, N, D, dtype)
    if offset:  # x starts `offset` elements into its storage
        buf = torch.empty(N * D + offset, dtype=dtype, device="cuda")
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(N, D)
    assert kernel.quant_path_cuda(x) == kernel.quant_path(
        D, dtype, aligned=x.data_ptr() % 16 == 0)
    before = (ops.launches, ops.launches_dequant)
    p, s = ops.quantize(x)
    p_p, s_p = quantize_int4_reference(x)
    assert torch.equal(p, p_p) and torch.equal(s, s_p)
    # and the host's numpy version, the layout contract
    p_np, s_np = quantize_int4_np(x.float().cpu().numpy())
    assert np.array_equal(p.cpu().numpy(), p_np)
    assert np.array_equal(s.cpu().numpy(), s_np)
    for out in (torch.float32, torch.bfloat16):
        y = ops.dequantize(p, s, dtype=out)
        assert y.dtype == out
        assert torch.equal(y, dequantize_int4_reference(p_p, s_p, dtype=out))
    assert (ops.launches, ops.launches_dequant) == (before[0] + 1,
                                                    before[1] + 2)


def test_int4_quant_at_rounding_ties_and_infinite_rows(gen):
    """The quantize's register path divides by the row's reciprocal with a
    correction step: quotients within 4 ulps of the ties k + 1/2, at a
    scale of their own a row, land where the IEEE quotient puts them (the
    plain version and quantize_int4_np); a row holding infinities takes
    `/` and gives its finite elements 0, as x / inf does."""
    import numpy as np
    from repro_torch.core.quantize import quantize_int4_np
    from repro_torch.kernels.int4_cache import ops
    from repro_torch.kernels.int4_cache.ref import quantize_int4_reference
    g = torch.Generator(device="cuda").manual_seed(1)
    s_t = torch.empty((256, 1), device="cuda").uniform_(-20, 20,
                                                        generator=g).exp()
    amax = s_t * 7
    s = torch.clamp_min(amax / torch.tensor(7.0, device="cuda"), 1e-12)
    k = torch.randint(-7, 7, (256, 1024), generator=g, device="cuda") + 0.5
    step = torch.randint(-4, 5, (256, 1024), generator=g, device="cuda",
                         dtype=torch.int32)
    x = ((k * s).view(torch.int32) + step).view(torch.float32)
    x[:, 0] = amax[:, 0]
    p, sc = ops.quantize(x)
    p_p, s_p = quantize_int4_reference(x)
    assert torch.equal(p, p_p) and torch.equal(sc, s_p)
    p_np, s_np = quantize_int4_np(x.cpu().numpy())
    assert np.array_equal(p.cpu().numpy(), p_np)
    x = _int4_rows(gen, 9, 1280, torch.float32)
    x[3, 5], x[3, 700] = float("inf"), -float("inf")
    p, sc = ops.quantize(x)
    p_p, s_p = quantize_int4_reference(x)
    assert torch.equal(sc, s_p) and sc[3].item() == float("inf")
    fin = torch.isfinite(x)
    lo, hi = (p.int() << 28) >> 28, p.int() >> 4
    lo_p, hi_p = (p_p.int() << 28) >> 28, p_p.int() >> 4
    assert torch.equal(lo[fin[:, 0::2]], lo_p[fin[:, 0::2]])
    assert torch.equal(hi[fin[:, 1::2]], hi_p[fin[:, 1::2]])
    assert (lo[3][fin[3, 0::2]] == 0).all() and (hi[3][fin[3, 1::2]] == 0).all()


def test_async_refresh_epoch_on_the_card_with_a_racing_scan(gen):
    """One async epoch (side-stream scatter, event-guarded flip) while a
    scan of the previous generation runs: the old scan sees its own rows,
    and after the flip a stale read equals a sync store's scan."""
    import numpy as np
    from repro_torch.core.store import EmbeddingStore
    rng = np.random.default_rng(0)
    E, n = 256, 20_000
    embs = rng.standard_normal((n, E)).astype(np.float32)
    q = rng.standard_normal((8, E)).astype(np.float32)
    st = EmbeddingStore(E, device="cuda")
    st.add_batch(np.arange(n), embs, np.zeros(n), np.ones(n))
    ref = st.set_bank_refresh("async", thread=False)
    old = st.search_batch(q, 10, impl="device", freshness="fresh")
    snap0 = st.device_bank.published
    new = rng.standard_normal((4096, E)).astype(np.float32)
    st.upgrade_batch(np.arange(4096), new)
    extra = rng.standard_normal((5000, E)).astype(np.float32)
    st.add_batch(np.arange(n, n + 5000), extra, np.zeros(5000),
                 np.ones(5000))
    epoch = ref.begin_epoch()
    ref.apply(epoch)                  # queued on the bank's side stream
    racing = st.device_bank.search(q, 10, state=snap0)
    ref.flip(epoch)
    assert all(ev is not None for ev in snap0.ready)
    assert all(ev is not None for ev in st.device_bank.published.ready)
    assert np.array_equal(racing[1], old[1])
    assert np.array_equal(snap0.uids[racing[0]], old[0])
    got = st.search_batch(q, 10, impl="device", freshness="stale")
    sync = EmbeddingStore(E, device="cuda")
    sync.add_batch(np.arange(n), embs, np.zeros(n), np.ones(n))
    sync.upgrade_batch(np.arange(4096), new)
    sync.add_batch(np.arange(n, n + 5000), extra, np.zeros(5000),
                   np.ones(5000))
    want = sync.search_batch(q, 10, impl="device")
    torch.cuda.synchronize()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    st.set_bank_refresh("sync")


@pytest.mark.parametrize("kind", ["int4", "gathered", "dense"])
def test_topk_kernels_with_no_valid_row(gen, kind):
    """``n_valid = 0`` (a bank shard with no fill) still launches, and
    every slot is dead: score -1e30."""
    from repro_torch.core.quantize import quantize_int4
    from repro_torch.kernels.retrieval_topk import ops
    bank = torch.randn((300, 64), generator=gen, device="cuda")
    q = torch.randn((5, 64), generator=gen, device="cuda")
    packed, scales = quantize_int4(bank)
    attr = {"int4": "launches", "gathered": "launches_gathered",
            "dense": "launches_dense"}[kind]
    before = getattr(ops, attr)
    if kind == "int4":
        s, i = ops.retrieval_topk_int4(q, packed, scales, 10, n_valid=0)
    elif kind == "gathered":
        ids = torch.randint(0, 300, (5, 40), generator=gen, device="cuda",
                            dtype=torch.int32)
        s, i = ops.retrieval_topk_int4_gathered(q, packed, scales, ids, 10,
                                                n_valid=0)
        assert (i == -1).all()
    else:
        s, i = ops.retrieval_topk(q, bank, 10, normalize=False, n_valid=0)
    torch.cuda.synchronize()
    assert getattr(ops, attr) == before + 1
    assert s.shape == (5, 10) and (s <= -1e29).all()


@pytest.mark.parametrize("store_int4", [True, False], ids=["int4", "fp32"])
def test_sharded_bank_on_the_card_equals_one_shard(gen, store_int4):
    """Four shards on one card against the one-shard bank over the same
    rows and mutations (a grow across shards included): the exhaustive scan
    (the dense one for fp32), and for int4 the union and gathered pruned
    scans, bit for bit, each launching once a shard."""
    import numpy as np
    from repro_torch.core.store import EmbeddingStore
    from repro_torch.kernels.retrieval_topk import ops
    rng = np.random.default_rng(0)
    E, n = 256, 3000
    embs = rng.standard_normal((n + 2000, E)).astype(np.float32)
    q = rng.standard_normal((8, E)).astype(np.float32)
    one = EmbeddingStore(E, store_int4=store_int4, device="cuda")
    many = EmbeddingStore(E, store_int4=store_int4, device="cuda")
    one.attach_device_bank(["cuda"])
    many.attach_device_bank(["cuda:0"] * 4)
    for st in (one, many):
        st.add_batch(np.arange(n), embs[:n], np.zeros(n), np.ones(n))
    attr = "launches" if store_int4 else "launches_dense"
    for step in range(2):
        want = one.search_batch(q, 10, impl="device")
        before = getattr(ops, attr)
        got = many.search_batch(q, 10, impl="device")
        assert getattr(ops, attr) == before + 4
        assert np.array_equal(got[0], want[0]) and \
            np.array_equal(got[1], want[1])
        for st in (one, many):  # grows 4096 -> 8192: rows change shards
            st.add_batch(np.arange(n, n + 2000), embs[n:], np.zeros(2000),
                         np.ones(2000))
            st.delete_batch([5 + step, 77 + step])
    assert many.device_bank.n_grows == 1
    assert many.device_bank.h2d_rows == one.device_bank.h2d_rows
    if not store_int4:
        return
    rows = np.unique(rng.integers(0, len(one), 700))
    ids = rng.integers(-1, len(one) + 50, (8, 300)).astype(np.int32)
    banks = [(st.device_bank, st.device_bank.published) for st in (one, many)]
    for k in (10, 64):
        (w_u, w_s), (g_u, g_s) = [b.search_rows(q, rows, k, state=s)
                                  for b, s in banks]
        assert np.array_equal(g_u, w_u) and np.array_equal(g_s, w_s)
        before = ops.launches_gathered
        (w_u, w_s), (g_u, g_s) = [b.search_gathered(q, ids, k, state=s)
                                  for b, s in banks]
        assert ops.launches_gathered == before + 5
        assert np.array_equal(g_u, w_u) and np.array_equal(g_s, w_s)


# the streamed kernel's edges: lengths off the 32-key tile, a length of 1,
# a split shorter than a tile (splits of 128 keys at least, the last one the
# remainder), G 1 to 8, D 16 / 32 / 64 / 128 in both dtypes, windows that
# start mid-tile
@pytest.mark.parametrize("B,S,H,KV,D,dtype,window,lengths", [
    (2, 100, 8, 2, 128, torch.float32, 0, (1, 100)),
    (3, 77, 6, 1, 64, torch.bfloat16, 10, (77, 5, 40)),
    (1, 40, 4, 4, 16, torch.float32, 0, (0,)),       # no valid position
    (2, 50, 16, 2, 32, torch.bfloat16, 0, (50, 60)),  # G = 8, length > S
    (3, 1000, 12, 2, 128, torch.bfloat16, 0, (77, 1000, 1)),
    (1, 20000, 8, 1, 64, torch.bfloat16, 0, (270,)),  # a 14-key last split
    (2, 200, 4, 4, 32, torch.bfloat16, 0, (150, 200)),  # G = 1
    (2, 300, 16, 2, 16, torch.bfloat16, 0, (299, 64)),  # G = 8, D = 16
    (2, 400, 12, 2, 128, torch.bfloat16, 45, (300, 400)),
    (2, 333, 32, 4, 128, torch.float32, 70, (333, 100)),
    (1, 129, 2, 2, 64, torch.float32, 0, (129,))])
def test_decode_kernel_matches_plain(gen, B, S, H, KV, D, dtype, window,
                                     lengths):
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_reference)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = ops.launches
    o = ops.decode_attention(q, k, v, lens, window=window)
    assert ops.launches == before + 1
    o_p = decode_attention_reference(q, k, v, lens, window=window)
    assert o.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert (o.float() - o_p.float()).abs().max().item() <= tol


def test_decode_kernel_is_deterministic_and_never_syncs(gen):
    """Two calls on the same inputs give the same bits, and the wrapper
    issues nothing that waits for the device (no .item(), .cpu() or
    .tolist() on lengths; torch's sync debug mode would raise)."""
    import inspect
    from repro_torch.kernels.decode_attention import kernel as DK
    src = inspect.getsource(DK.decode_attn_cuda)
    assert not any(w in src for w in (".item(", ".cpu(", ".tolist("))
    bf = torch.bfloat16
    B, S, H, KV, D = 4, 3000, 12, 2, 128
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(bf)
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(bf)
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(bf)
    lens = torch.tensor([3000, 1777, 31, 2048], dtype=torch.int32,
                        device="cuda")
    DK.decode_attn_cuda(q, k, v, lens)  # built and loaded before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        o1 = DK.decode_attn_cuda(q, k, v, lens)
        o2 = DK.decode_attn_cuda(q, k, v, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("T,d,E,F,bt,dtype,kind", [
    (300, 64, 8, 128, 64, torch.bfloat16, "random"),
    (77, 40, 8, 768, 16, torch.bfloat16, "empty"),   # d, T ragged; F = 768
    (128, 16, 8, 32, 16, torch.float32, "one"),      # all on one expert
    (50, 256, 4, 100, 16, torch.bfloat16, "random")])  # F ragged
def test_moe_gemm_kernel_matches_plain(gen, T, d, E, F, bt, dtype, kind):
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import (moe_gemm_reference,
                                                  moe_gemm_sorted_reference)
    if kind == "one":
        eid = torch.full((T,), 3, dtype=torch.int32, device="cuda")
    else:
        eid = torch.randint(0, E, (T,), generator=gen, device="cuda",
                            dtype=torch.int32)
        if kind == "empty":
            eid = eid // 2 * 2
    x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, d, F), generator=gen, device="cuda") * 0.1).to(dtype)
    p = ops.plan(eid, E, bt)
    xs = ops.scatter_rows(x, p)
    before = ops.launches
    ys = ops.moe_gemm_sorted(xs, p.block_expert, w, bt, p.used, p.ends)
    assert ops.launches == before + 1
    ys_p = moe_gemm_sorted_reference(xs, p.block_expert, w, bt, p.used)
    n = int(p.used)
    scale = max(1.0, ys_p[:n].float().abs().max().item())
    # f32: another summation order; bf16: one output rounding step
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert (ys[:n].float() - ys_p[:n].float()).abs().max().item() <= \
        rel * scale
    y = ops.moe_gemm(x, eid, w, block_t=bt)
    y_p = moe_gemm_reference(x, eid, w)
    assert (y.float() - y_p.float()).abs().max().item() <= rel * scale


@pytest.mark.parametrize("T,d,E,F,bt,kind", [
    (4096, 512, 16, 768, 128, "single"),   # one expert's group is one row
    (1000, 256, 8, 1408, 64, "random"),
    (777, 200, 8, 384, 128, "random"),     # d ragged against the 64-deep slice
    (300, 64, 8, 104, 64, "empty")])       # F ragged against 256 columns
def test_moe_gemm_both_kernels_match_plain(gen, T, d, E, F, bt, kind):
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_sorted_reference
    bf = torch.bfloat16
    eid = torch.randint(0, E - 1, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if kind == "single":
        eid[T // 3] = E - 1
    elif kind == "empty":
        eid = eid // 2 * 2
    x = torch.randn((T, d), generator=gen, device="cuda").to(bf)
    w = (torch.randn((E, d, F), generator=gen, device="cuda") * 0.1).to(bf)
    p = ops.plan(eid, E, bt)
    xs = ops.scatter_rows(x, p)
    ys_p = moe_gemm_sorted_reference(xs, p.block_expert, w, bt, p.used)
    n = int(p.used)
    lim = 2.0 ** -7 * max(1.0, ys_p[:n].float().abs().max().item())
    assert kernel_for(bf, bt, d, F) == "wgmma"
    for kernel in ("wgmma", "mma_sync"):
        ys = moe_gemm_cuda(xs, p.block_expert, w, bt, p.used, kernel=kernel)
        assert (ys[:n].float() - ys_p[:n].float()).abs().max().item() <= lim
    before = dict(ops.launches_by_kernel)
    ops.moe_gemm_sorted(xs, p.block_expert, w, bt, p.used, p.ends)
    assert ops.launches_by_kernel["wgmma"] == before.get("wgmma", 0) + 1
    assert ops.launches_by_kernel.get("mma_sync", 0) == \
        before.get("mma_sync", 0)


# the fused gate/up kernel (moe_gemm_wgmma_swiglu): Moonlight's shape (d
# 2,048, F 1,408 = 11 x 128, E 64, 128-row blocks), a ragged side shape (F
# 768, 64-row blocks), F with a half atom (96) and F 200 (three atoms and a
# part), empty experts and padding rows
@pytest.mark.parametrize("T,d,E,F,bt,kind", [
    (16384, 2048, 64, 1408, 128, "random"),
    (3000, 512, 16, 768, 64, "empty"),
    (1000, 256, 8, 96, 64, "random"),
    (777, 200, 8, 200, 128, "empty")])
def test_moe_gemm_swiglu_kernel_matches_plain(gen, T, d, E, F, bt, kind):
    """h = SiLU(g) * u in one launch against the three steps it replaces on
    the card (gate and up on ``moe_gemm_wgmma``, then the torch SiLU chain),
    which round g and u as it does: within one bf16 step per element
    (``bf16_step_limit``); against the plain version (fp32 products, another
    summation order, so g and u may round a step apart) within one output
    rounding step of h's scale. Rows from ``used`` on are not read (NaN
    there) nor written (a launch into a NaN-filled h leaves them NaN); each
    call counts one ``swiglu_wgmma`` launch, and a gradient through it
    raises."""
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import _lib
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_swiglu_reference)
    bf = torch.bfloat16
    eid = torch.randint(0, E, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if kind == "empty":
        eid = eid // 2 * 2
    x = torch.randn((T, d), generator=gen, device="cuda").to(bf)
    wg, wu = ((torch.randn((E, d, F), generator=gen, device="cuda")
               * d ** -0.5).to(bf) for _ in range(2))
    p = ops.plan(eid, E, bt)
    xs = ops.scatter_rows(x, p)
    n = int(p.used)
    assert n < p.T_pad and ops.swiglu_takes(xs, wg, wu, bt)
    xs[n:] = float("nan")
    before = (ops.launches, dict(ops.launches_by_kernel))
    h = ops.moe_gemm_sorted_swiglu(xs, p.block_expert, wg, wu, bt, p.used)
    assert ops.launches == before[0] + 1
    assert ops.launches_by_kernel["swiglu_wgmma"] == \
        before[1].get("swiglu_wgmma", 0) + 1
    assert {k: v for k, v in ops.launches_by_kernel.items()
            if k != "swiglu_wgmma"} == \
        {k: v for k, v in before[1].items() if k != "swiglu_wgmma"}
    g = ops.moe_gemm_sorted(xs, p.block_expert, wg, bt, p.used, p.ends)
    u = ops.moe_gemm_sorted(xs, p.block_expert, wu, bt, p.used, p.ends)
    steps = (Fn.silu(g.float()).to(bf) * u)[:n]
    assert ((h[:n].float() - steps.float()).abs()
            <= bf16_step_limit(steps)).all()
    h_p = moe_gemm_sorted_swiglu_reference(xs, p.block_expert, wg, wu, bt,
                                           p.used)[:n]
    scale = max(1.0, h_p.float().abs().max().item())
    assert (h[:n].float() - h_p.float()).abs().max().item() <= \
        2.0 ** -7 * scale
    filled = torch.full_like(h, float("nan"))
    err = _lib().moe_gemm_swiglu_wgmma_launch(
        xs.data_ptr(), p.block_expert.data_ptr(), wg.data_ptr(),
        wu.data_ptr(), p.used.data_ptr(), filled.data_ptr(), p.T_pad, d, F,
        E, bt, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    assert torch.equal(filled[:n], h[:n]) and filled[n:].isnan().all()
    wl = wg.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.moe_gemm_sorted_swiglu(xs, p.block_expert, wl, wu, bt, p.used)


def test_moe_dropless_takes_the_fused_gate_up_without_grad(gen):
    """DeepSeek-V3's MoE layer (``moe_apply_dropless``) at Moonlight's
    expert width (64 experts of 1,408, top-6, 2 shared) over 2 x 512 bf16
    tokens: under ``no_grad`` the grouped GEMMs are one fused gate/up and
    one down launch and the rows move on one dispatch and one combine
    launch; with a gradient recorded through x, three grouped GEMMs and no
    row kernel; the two outputs within one bf16 step of the output's scale
    (the moonlight phase's call-by-call tolerance of ``chip_smoke.py``)."""
    from repro_torch.configs.base import MoEConfig, RouterConfig
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.models import moe as TM
    from repro_torch.models.layers import init_params
    moe = MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                    n_shared_experts=2)
    router = RouterConfig(routed_scaling_factor=2.446)
    d = 512
    params = init_params(gen, TM.moe_schema(d, moe, router=router),
                         dtype=torch.bfloat16, device="cuda")
    x = torch.randn((2, 512, d), generator=gen, device="cuda").to(
        torch.bfloat16)

    def delta(counter, before):
        return {k: v - before.get(k, 0) for k, v in counter.items()
                if v != before.get(k, 0)}

    def run(grad):
        before = (dict(ops.launches_by_kernel),
                  dict(ops.row_launches_by_kernel))
        xl = x.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y, _ = TM.moe_apply_dropless(params, xl, moe, router)
        return y.detach(), delta(ops.launches_by_kernel, before[0]), \
            delta(ops.row_launches_by_kernel, before[1])

    fused, fused_launches, fused_rows = run(False)
    three, three_launches, three_rows = run(True)
    assert fused_launches == {"swiglu_wgmma": 1, "wgmma": 1}
    assert three_launches == {"wgmma": 3}
    # the row kernels where no gradient is recorded, the torch steps else
    assert fused_rows == {"dispatch": 1, "combine": 1}
    assert three_rows == {}
    scale = max(1.0, three.float().abs().max().item())
    assert (fused.float() - three.float()).abs().max().item() <= \
        2.0 ** -7 * scale


# the row kernels (csrc/moe_rows.cu) at moonlight.prefill_8k's shape (8 x
# 8,192 tokens, top-6 of 64 experts, d 2,048, 128-row blocks) and beside it:
# a decode-sized batch on 16-row blocks, qwen3-moe's top-8 of 128, fp32,
# widths that take the 8-, 4- and 2-byte moves (d 36, 18 bf16; 33 f32)
ROW_CASES = [(65536, 6, 64, 2048, 128, torch.bfloat16),
             (37, 6, 64, 2048, 16, torch.bfloat16),
             (16384, 8, 128, 2048, 128, torch.bfloat16),
             (300, 6, 8, 256, 64, torch.float32),
             (200, 2, 8, 36, 16, torch.bfloat16),
             (77, 3, 4, 18, 16, torch.bfloat16),
             (100, 1, 4, 33, 16, torch.float32)]


def _row_case(gen, T, K, E, bt):
    """A plan of T tokens' top-K distinct experts of E (as a router picks
    them), on ``bt``-row blocks."""
    from repro_torch.kernels.moe_gemm import ops
    ids = torch.rand((T, E), generator=gen, device="cuda").topk(K).indices
    return ops.plan(ids.reshape(-1), E, bt)


@pytest.mark.parametrize("T,K,E,d,bt,dtype", ROW_CASES)
def test_moe_dispatch_rows_kernel_matches_scatter_rows(gen, T, K, E, d, bt,
                                                       dtype):
    """``moe_dispatch_rows`` against ``scatter_rows`` (and the plain
    version) bit for bit on every row below ``used``, the padding rows
    zeroed; launched into a NaN-filled buffer it leaves the rows from
    ``used`` on as they were; ``dispatch_rows`` counts one ``dispatch``
    row launch and no GEMM launch, and refuses a gradient."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import _rows_lib
    from repro_torch.kernels.moe_gemm.ref import dispatch_rows_reference
    p = _row_case(gen, T, K, E, bt)
    x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    n = int(p.used)
    want = ops.scatter_rows(x, p, K)
    before = (ops.launches, ops.row_launches,
              ops.row_launches_by_kernel.get("dispatch", 0))
    xs = ops.dispatch_rows(x, p, K)
    assert (ops.launches, ops.row_launches,
            ops.row_launches_by_kernel["dispatch"]) == \
        (before[0], before[1] + 1, before[2] + 1)
    assert xs.shape == want.shape and xs.dtype == dtype
    assert torch.equal(xs[:n], want[:n])
    assert torch.equal(xs[:n], dispatch_rows_reference(x, p.slot_of, p.T_pad,
                                                       K)[:n])
    filled = torch.full_like(want, float("nan"))
    err = _rows_lib().moe_dispatch_rows_launch(
        x.data_ptr(), p.slot_of.data_ptr(), p.counts.data_ptr(),
        p.ends.data_ptr(), filled.data_ptr(), T, K, E, d * x.element_size(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    assert torch.equal(filled[:n], want[:n]) and filled[n:].isnan().all()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.dispatch_rows(x.clone().requires_grad_(), p, K)


@pytest.mark.parametrize("T,K,E,d,bt,dtype", ROW_CASES)
def test_moe_combine_rows_kernel_within_a_step_of_bmm(gen, T, K, E, d, bt,
                                                      dtype):
    """``moe_combine_rows`` against the gather and batched product it
    replaces (the plain version, run on the card: cuBLAS's bmm), per element
    within one bf16 step (``bf16_step_limit``) or 1e-5 of the scale (f32);
    in bf16 bit for bit the fp32 sum in the order k = 0 .. K - 1 of the
    rounded weights times the rows (each product exact in fp32), rounded
    once; the same bits twice; no row from ``used`` on is read (NaN there);
    ``combine_rows`` counts one ``combine`` row launch."""
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import combine_rows_reference
    p = _row_case(gen, T, K, E, bt)
    n = int(p.used)
    ys = torch.randn((p.T_pad, d), generator=gen, device="cuda").to(dtype)
    ys[n:] = float("nan")
    w = torch.rand((T, K), generator=gen, device="cuda") * 2.446
    before = (ops.launches, ops.row_launches_by_kernel.get("combine", 0))
    y = ops.combine_rows(ys, p, w)
    assert (ops.launches, ops.row_launches_by_kernel["combine"]) == \
        (before[0], before[1] + 1)
    assert torch.equal(ops.combine_rows(ys, p, w), y)
    want = combine_rows_reference(ys, p.slot_of, w)
    assert y.shape == (T, d) and y.dtype == dtype
    if dtype == torch.bfloat16:
        assert ((y.float() - want.float()).abs()
                <= bf16_step_limit(want)).all()
        rows = ys[p.slot_of.long()].view(T, K, d).float()
        wb = w.to(dtype).float()
        acc = torch.zeros((T, d), device="cuda")
        for k in range(K):
            acc = acc + wb[:, k, None] * rows[:, k]
        assert torch.equal(y, acc.to(dtype))
    else:
        scale = max(1.0, want.abs().max().item())
        assert (y - want).abs().max().item() <= 1e-5 * scale
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.combine_rows(ys, p, w.clone().requires_grad_())


def test_moonlight_smoke_prefill_moves_rows_on_the_row_kernels(gen):
    """moonlight-16b-a3b's smoke variant in bf16 with the published MLA
    head dims (q/k 192, v 128: the MLA kernel's only shape) through
    build_step's prefill and one decode step under ``no_grad``: one
    dispatch and one combine launch a MoE layer a call, and exit embeddings
    within one bf16 step of their scale of the torch steps'
    (``rows_take`` false), which sum the top-k rows in another order."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_variant
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.launch.steps import build_step
    from repro_torch.models.transformer import lm_init
    full = get_arch("moonlight-16b-a3b").model
    spec = smoke_variant(get_arch("moonlight-16b-a3b"))
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, mla=dataclasses.replace(
            spec.model.mla, qk_nope_head_dim=full.mla.qk_nope_head_dim,
            qk_rope_head_dim=full.mla.qk_rope_head_dim,
            v_head_dim=full.mla.v_head_dim),
        d_head=full.mla.qk_head_dim, dtype="bfloat16"))
    cfg = spec.model
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert n_moe > 0
    params = lm_init(gen, cfg, spec.recall, device="cuda")
    B, S = 2, 64
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    pre = build_step(spec, ShapeConfig("p", "prefill", B, S), device="cuda",
                     pad_to=S + 1).fn
    dec = build_step(spec, ShapeConfig("d", "decode", B, S + 1),
                     device="cuda").fn
    lengths = torch.full((B,), S + 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        before = dict(ops.row_launches_by_kernel)
        out = pre(params, tokens[:, :S])
        after_pre = dict(ops.row_launches_by_kernel)
        dec(params, tokens[:, S], out["latent_cache"], lengths)
        after_dec = dict(ops.row_launches_by_kernel)
        with mock.patch.object(ops, "rows_take", lambda *t: False):
            steps = pre(params, tokens[:, :S])
    for k in ("dispatch", "combine"):
        assert after_pre[k] - before.get(k, 0) == n_moe
        assert after_dec[k] - after_pre[k] == n_moe
    assert dict(ops.row_launches_by_kernel) == after_dec
    got, want = out["exit_embs"].float(), steps["exit_embs"].float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= \
        2.0 ** -7 * max(1.0, want.abs().max().item())


def test_lm_prefill_and_decode_on_the_card_match_the_cpu(gen):
    """A small fp32 MoE LM (head dim 64, GQA 2:1, 8 experts top-2) through
    prefill and two greedy decode steps on the card (flash, rmsnorm,
    decode attention and the grouped GEMM kernels) against the same
    weights on the CPU (the plain versions)."""
    from repro_torch.configs.base import LMConfig, MoEConfig, RecallConfig
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.models import transformer as T
    cfg = LMConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   d_head=64, d_ff=0, vocab=300, rope_theta=1e4,
                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96),
                   dtype="float32")
    rc = RecallConfig(exit_interval=1)
    params = T.lm_init(gen, cfg, rc, device="cuda")

    def to(tree, dev):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        return {k: to(v, dev) for k, v in tree.items()}

    p_cpu = to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 20), generator=gen,
                           device="cuda", dtype=torch.int32)
    outs = {}
    for dev, p in (("cuda", params), ("cpu", p_cpu)):
        before = (dec_ops.launches, moe_ops.launches)
        pre = T.prefill(p, cfg, rc, tokens.to(dev), pad_to=32)
        k, v = pre["k_cache"], pre["v_cache"]
        lengths = torch.tensor([21, 15, 21], dtype=torch.int32, device=dev)
        token = tokens[:, -1].to(dev)
        logits = []
        for _ in range(2):
            lg, k, v = T.decode_step(p, cfg, rc, token, k, v, lengths)
            logits.append(lg)
            token = lg.argmax(-1).to(torch.int32)
            lengths = lengths + 1
        outs[dev] = (pre["exit_embs"], k, torch.stack(logits))
        if dev == "cuda":
            assert dec_ops.launches == before[0] + 2 * cfg.n_layers
            assert moe_ops.launches == before[1] + 3 * 3 * cfg.n_layers
    for got, want in zip(outs["cuda"], outs["cpu"]):
        scale = max(1.0, want.abs().max().item())
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * scale


def _moe_bwd_case(gen, T, d, E, F, bt, dtype):
    """A plan whose experts E // 2 and E - 1 get no rows (blocks past the
    last group name E - 1), xs and dys with NaN from ``used`` on."""
    from repro_torch.kernels.moe_gemm import ops
    eid = torch.randint(0, E - 1, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    eid[eid == E // 2] = 0
    p = ops.plan(eid, E, bt)
    x = torch.randn((T, d), generator=gen, device="cuda").to(dtype)
    xs = ops.scatter_rows(x, p)
    dys = torch.randn((p.T_pad, F), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, d, F), generator=gen, device="cuda") * 0.1).to(dtype)
    n = int(p.used)
    assert n < p.T_pad
    xs[n:] = float("nan")
    dys[n:] = float("nan")
    return p, xs, dys, w


def _moe_bwd64(p, xs, dys, w, bt):
    """The two gradients as float64 products over each expert's group."""
    from repro_torch.kernels.moe_gemm.ref import _groups
    dx = torch.zeros((xs.shape[0], w.shape[1]), dtype=torch.float64,
                     device="cuda")
    dw = torch.zeros(w.shape, dtype=torch.float64, device="cuda")
    for e, r0, r1 in _groups(p.block_expert, bt, p.used):
        dx[r0:r1] = dys[r0:r1].double() @ w[e].double().T
        dw[e] = xs[r0:r1].double().T @ dys[r0:r1].double()
    return dx, dw


def _moe_bwd_gate(got, plain, g64, what):
    """Against float64 relative to each element (``bwd_rel_err``) within
    ``REL_MULTIPLE`` times the plain version's; beside it, bf16 within one
    bf16 step of the plain version at max(|g|, 1), f32 within 1e-5 of the
    tensor's largest element (the forward's gate: an fp32 sum of a few
    hundred rows whose partial sums reach 20-40 moves a small element by
    up to 5e-5 in either order)."""
    from repro_torch.kernels.flash_attention.ref import (REL_MULTIPLE,
                                                         bwd_limit,
                                                         bwd_rel_err)
    assert got.dtype == plain.dtype and got.shape == plain.shape, what
    assert torch.isfinite(got).all(), what
    err = (got.float() - plain.float()).abs()
    if got.dtype == torch.bfloat16:
        assert (err <= bwd_limit(plain)).all(), (what, err.max().item())
    else:
        assert err.max().item() <= 1e-5 * plain.abs().max().item(), what
    rel, rel_plain = bwd_rel_err(got, g64), bwd_rel_err(plain, g64)
    assert rel <= REL_MULTIPLE * rel_plain, (what, rel, rel_plain)


# E, d: the experts and widths of the case. (8, 256) is 48 to 64 dW tiles
# of 128 x 256; (2, 256) fewer tiles than SMs and one expert with every row;
# (64, 320) ten times more tiles than SMs, so each persistent dW block walks
# several, and d not a multiple of the 128-row tile (the second warpgroup's
# rows past d are clipped). F 96 and 1,408 leave a partial 256-column tile
# that the TMA store clips.
@pytest.mark.parametrize("E,d", [(8, 256), (2, 256), (64, 320)])
@pytest.mark.parametrize("F", [96, 768, 1408])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bt", [16, 64, 128])
def test_moe_gemm_bwd_kernels_match_plain(gen, bt, dtype, F, E, d):
    """The gradients of xs and of w (each kernel that takes the shape)
    against their plain versions and a float64 product, with experts that
    have no rows (E // 2 and E - 1, which the blocks past the last group
    name) and NaN in xs and dys from ``used`` on: dX writes 0 there and
    reads nothing, dW reads no row there; the same bits twice."""
    from repro_torch.kernels.moe_gemm.kernel import (kernel_for,
                                                     moe_gemm_cuda,
                                                     moe_gemm_dw_cuda)
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference)
    T = 1000
    p, xs, dys, w = _moe_bwd_case(gen, T, d, E, F, bt, dtype)
    dx64, dw64 = _moe_bwd64(p, xs, dys, w, bt)
    dx_p = moe_gemm_sorted_dx_reference(dys, p.block_expert, w, bt, p.used)
    dw_p = moe_gemm_sorted_dw_reference(xs, dys, p.block_expert, E, bt,
                                        p.used)
    kernels = ("wgmma", "mma_sync") if kernel_for(dtype, bt, d, F) == \
        "wgmma" else ("mma_sync",)
    for kernel in kernels:
        dx = moe_gemm_cuda(dys, p.block_expert, w, bt, p.used, kernel=kernel,
                           dx=True)
        again = moe_gemm_cuda(dys, p.block_expert, w, bt, p.used,
                              kernel=kernel, dx=True)
        assert torch.equal(dx, again), kernel
        assert not dx[int(p.used):].any(), kernel
        _moe_bwd_gate(dx, dx_p, dx64, f"dx {kernel}")
    for kernel in kernels:
        dw = moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used, kernel=kernel)
        assert torch.equal(dw, moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used,
                                                kernel=kernel)), kernel
        assert not dw[E // 2].any() and not dw[E - 1].any(), kernel
        _moe_bwd_gate(dw, dw_p, dw64, f"dw {kernel}")


# T, E, d, F, bt, plan for the persistent dX kernel (128 or 64 rows x 256
# columns of d a tile, 132 blocks on an H100). "random": _moe_bwd_case's
# plan (experts E // 2 and E - 1 empty, NaN in dys from used on); "one":
# every row on expert 3, NaN from used on; "full": block experts drawn and
# sorted by hand so the groups fill T_pad (used == T_pad: no zero tile).
# 40,000 rows give 2,632 tiles, about 20 a block, so each block crosses
# experts mid-loop; d 320 and 1,408 leave a partial 256-column tile that the
# TMA store clips (at bt 64 and d 320 the second warpgroup's 128 columns lie
# past d); F 96 is half a 64-deep slice.
DX_WGMMA_CASES = [
    (40000, 16, 2048, 768, 128, "random"),
    (4000, 8, 320, 768, 128, "random"),
    (6000, 8, 1408, 96, 128, "random"),
    (20000, 16, 2048, 768, 64, "random"),
    (4000, 8, 320, 1408, 64, "random"),
    (5000, 8, 2048, 768, 128, "one"),
    (5000, 8, 768, 2048, 64, "one"),
    (51200, 8, 768, 2048, 128, "full"),
    (12800, 8, 320, 768, 64, "full"),
]


@pytest.mark.parametrize("T,E,d,F,bt,kind", DX_WGMMA_CASES)
def test_moe_gemm_dx_wgmma_walks_many_tiles(gen, T, E, d, F, bt, kind):
    """The persistent wgmma dX kernel (``moe_gemm_dx_wgmma``) with the
    gates of ``test_moe_gemm_bwd_kernels_match_plain``: 0 from ``used`` on
    (where dys holds NaN and is not read), the same bits twice, within
    ``bwd_limit`` of the plain version and within ``REL_MULTIPLE`` times
    its float64-relative error."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    from repro_torch.kernels.moe_gemm.ref import (
        _groups, moe_gemm_sorted_dx_reference)
    bf16 = torch.bfloat16
    assert kernel_for(bf16, bt, d, F) == "wgmma"
    if kind == "random":
        p, _, dys, w = _moe_bwd_case(gen, T, d, E, F, bt, bf16)
        block_expert, used, T_pad = p.block_expert, p.used, p.T_pad
    elif kind == "one":
        p = ops.plan(torch.full((T,), 3, dtype=torch.int32, device="cuda"),
                     E, bt)
        block_expert, used, T_pad = p.block_expert, p.used, p.T_pad
        dys = torch.randn((T_pad, F), generator=gen, device="cuda").to(bf16)
        assert int(used) < T_pad
        dys[int(used):] = float("nan")
    else:
        T_pad = T
        block_expert = torch.randint(0, E, (T_pad // bt,), generator=gen,
                                     device="cuda", dtype=torch.int32)
        block_expert = block_expert.sort().values
        used = torch.tensor(T_pad, dtype=torch.int32, device="cuda")
        dys = torch.randn((T_pad, F), generator=gen, device="cuda").to(bf16)
    if kind != "random":
        w = (torch.randn((E, d, F), generator=gen, device="cuda")
             * 0.1).to(bf16)
    n = int(used)
    dx = moe_gemm_cuda(dys, block_expert, w, bt, used, kernel="wgmma",
                       dx=True)
    assert torch.equal(dx, moe_gemm_cuda(dys, block_expert, w, bt, used,
                                         kernel="wgmma", dx=True))
    assert not dx[n:].any()
    dx64 = torch.zeros((T_pad, d), dtype=torch.float64, device="cuda")
    for e, r0, r1 in _groups(block_expert, bt, used):
        dx64[r0:r1] = dys[r0:r1].double() @ w[e].double().T
    dx_p = moe_gemm_sorted_dx_reference(dys, block_expert, w, bt, used)
    _moe_bwd_gate(dx, dx_p, dx64, f"dx wgmma {kind}")


def test_moe_gemm_autograd_launches_only_the_gradients_needed(gen):
    """Under grad mode the grouped GEMM's backward launches dX only for an
    xs that needs a gradient and dW only for a w that does; the gradients
    are the plain versions' (at the wgmma kernel's bf16 blocks of 128)."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import (
        moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference)
    T, d, E, F, bt = 4096, 256, 16, 128, 128
    p, xs, dys, w = _moe_bwd_case(gen, T, d, E, F, bt, torch.bfloat16)
    n = int(p.used)
    xs[n:] = 0
    dys[n:] = 0
    for need_x, need_w in ((True, False), (False, True), (True, True)):
        xl, wl = (t.clone().requires_grad_(r) for t, r in
                  ((xs, need_x), (w, need_w)))
        before = (ops.launches, dict(ops.bwd_launches_by_kernel),
                  ops.bwd_launches)
        ys = ops.moe_gemm_sorted(xl, p.block_expert, wl, bt, p.used, p.ends)
        grads = torch.autograd.grad(ys, [t for t in (xl, wl)
                                         if t.requires_grad], dys)
        got = {k: v - before[1].get(k, 0)
               for k, v in ops.bwd_launches_by_kernel.items()}
        assert ops.launches == before[0] + 1
        assert got.get("dx_wgmma", 0) == int(need_x)
        assert got.get("dw_wgmma", 0) == int(need_w)
        assert got.get("dx_mma_sync", 0) == 0
        assert got.get("dw_mma_sync", 0) == 0
        assert ops.bwd_launches == before[2] + need_x + need_w
        want = ([moe_gemm_sorted_dx_reference(dys, p.block_expert, w, bt,
                                              p.used)] if need_x else []) \
            + ([moe_gemm_sorted_dw_reference(xs, dys, p.block_expert, E, bt,
                                             p.used)] if need_w else [])
        for g, wt in zip(grads, want):
            assert ((g.float() - wt.float()).abs()
                    <= 2.0 ** -7 * wt.float().abs().clamp_min(1.0)).all()


def test_tma_kernels_launch_from_a_fresh_thread(gen):
    """A TMA kernel (the grouped GEMM's wgmma forward and dX, the bf16 flash
    forward) as the first CUDA call of a new host thread, as in an autograd
    worker: the tensor-map encode needs a context bound to the thread
    (``hopper.cuh``'s ``encode_bf16_map`` binds it)."""
    import threading
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_cuda
    T, d, E, F, bt = 4096, 256, 16, 128, 128
    p, xs, dys, w = _moe_bwd_case(gen, T, d, E, F, bt, torch.bfloat16)
    q = torch.randn((2, 128, 4, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    calls = (lambda: moe_gemm_cuda(xs, p.block_expert, w, bt, p.used),
             lambda: moe_gemm_cuda(dys, p.block_expert, w, bt, p.used,
                                   dx=True),
             lambda: flash_fwd_cuda(q, q, q, causal=True))
    torch.cuda.synchronize()
    for call in calls:
        errors = []

        def body():
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                errors.append(e)
        t = threading.Thread(target=body)
        t.start()
        t.join()
        assert not errors, errors


def _moe_layer_grads(params, x, moe):
    from repro_torch.models import moe as TM
    leaves = [x] + [params[k] for k in ("router", "w_gate", "w_up",
                                         "w_down")]
    y, aux = TM.moe_apply(params, x, moe)
    g = torch.randn(y.shape, generator=torch.Generator(
        device=y.device).manual_seed(1), device=y.device).to(y.dtype)
    return torch.autograd.grad((y.float() * g.float()).sum() + aux, leaves)


def test_moe_layer_backward_is_deterministic(gen):
    """A bf16 MoE layer (16 experts top-4, 2 x 256 tokens: the wgmma
    kernel's 128-row blocks, some assignments dropped) forward and
    backward twice: the gradients of
    x, the router and the three expert weights have the same bits."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels.moe_gemm import ops
    moe = MoEConfig(n_experts=16, top_k=4, d_ff_expert=96,
                    capacity_factor=1.0)
    d, E = 256, moe.n_experts
    bf = torch.bfloat16
    params = {"router": torch.randn((d, E), generator=gen, device="cuda")
              * d ** -0.5,
              **{k: (torch.randn(s, generator=gen, device="cuda")
                     * s[1] ** -0.5).to(bf)
                 for k, s in (("w_gate", (E, d, 96)), ("w_up", (E, d, 96)),
                              ("w_down", (E, 96, d)))}}
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.randn((2, 256, d), generator=gen, device="cuda").to(
        bf).requires_grad_()
    before = dict(ops.bwd_launches_by_kernel)
    first = _moe_layer_grads(params, x, moe)
    assert ops.bwd_launches_by_kernel["dx_wgmma"] == \
        before.get("dx_wgmma", 0) + 3
    assert ops.bwd_launches_by_kernel["dw_wgmma"] == \
        before.get("dw_wgmma", 0) + 3
    second = _moe_layer_grads(params, x, moe)
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_moe_lm_lora_and_weight_grads_on_the_card_match_the_cpu(gen):
    """A small fp32 MoE LM (8 experts top-2) with a random non-zero LoRA:
    the exit-distillation loss's gradients of the LoRA and of the MoE
    layers' router and expert weights through the kernels (flash, RMSNorm
    and the grouped GEMM, forward and backward) on the card against the
    same weights on the CPU (the plain versions), within 1e-4 of each
    leaf's scale; three dX and three dW launches a layer."""
    from repro_torch.configs.base import LMConfig, MoEConfig, RecallConfig
    from repro_torch.core import healing as H
    from repro_torch.core import plora
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.models import transformer as T
    cfg = LMConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   d_head=64, d_ff=0, vocab=300, rope_theta=1e4,
                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                                 capacity_factor=1.0),
                   dtype="float32")
    rc = RecallConfig(exit_interval=1, lora_rank=4)
    params = T.lm_init(gen, cfg, rc, device="cuda")
    a = params["layers"]["attn"]  # at fan-in d (see the tower test above)
    for w in ("wq", "wk", "wv"):
        a[w] = a[w] * (cfg.n_heads / cfg.d_model) ** 0.5
    a["wo"] = a["wo"] / cfg.n_heads ** 0.5
    lora = plora.lora_init(gen, cfg, rc, device="cuda")
    lora = {t: {"a": ab["a"], "b": 0.05 * torch.randn(
        ab["b"].shape, generator=gen, device="cuda")}
        for t, ab in lora.items()}
    tokens = torch.randint(0, cfg.vocab, (3, 40), generator=gen,
                           device="cuda", dtype=torch.int32)
    n_exits = len(rc.exit_layers(cfg.n_layers))
    grads = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        moe_p = p["layers"]["moe"]
        for k in ("router", "w_gate", "w_up", "w_down"):
            moe_p[k].requires_grad_()
        lp = _to(lora, dev)
        leaves = [lp[n][ab].requires_grad_() for n in sorted(lp)
                  for ab in ("a", "b")] + [moe_p[k] for k in (
                      "router", "w_gate", "w_up", "w_down")]
        with torch.no_grad():
            out = T.forward_hidden(p, cfg, rc, tokens=tokens.to(dev),
                                   collect_pooled=True)
            t = T.exit_embedding(p, out["pooled"][-1], cfg.norm_eps)
        before = dict(moe_ops.bwd_launches_by_kernel)
        loss = H.exit_distill_loss(
            H.lm_exit_embs(p, cfg, rc, tokens.to(dev), lp), t,
            torch.full((n_exits,), 1.0 / n_exits, device=dev),
            torch.ones(n_exits, device=dev))
        grads[dev] = torch.autograd.grad(loss, leaves)
        if dev == "cuda":
            got = {k: v - before.get(k, 0)
                   for k, v in moe_ops.bwd_launches_by_kernel.items()
                   if v != before.get(k, 0)}
            assert got == {"dx_mma_sync": 3 * cfg.n_layers,
                           "dw_mma_sync": 3 * cfg.n_layers}, got
    for g, c in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-6, c.abs().max().item())
        assert (g.cpu() - c).abs().max().item() <= 1e-4 * scale


# the backward kernels (flash dQ and dK/dV, RMSNorm dx/dscale) against
# their plain versions: every head dim, both dtypes, GQA, causal with
# q_offset, windows, ragged lengths, rows that see no key
FLASH_BWD_CASES = [  # B, Sq, Skv, H, KV, D, causal, window, q_offset
    (2, 37, 45, 4, 2, 64, True, 0, 5),
    (2, 70, 70, 4, 4, 80, False, 0, 0),
    (1, 100, 130, 6, 2, 128, True, 0, 30),
    (2, 150, 150, 4, 2, 80, False, 33, 0),
    (1, 64, 40, 2, 2, 64, True, 0, -30),     # rows before every key
    (1, 200, 50, 2, 2, 128, False, 5, 60),   # windows past every key
    (2, 150, 90, 4, 2, 80, True, 40, 70),    # both, in a mixed tile
    (1, 300, 300, 12, 2, 128, True, 0, 0),   # qwen2's ratio, ragged tiles
    (2, 257, 257, 4, 4, 80, False, 0, 0),    # the vision tower's S and D
    (2, 33, 9, 4, 1, 64, True, 0, -3),       # Skv < 16, G = 4, keyless rows
    (2, 229, 229, 12, 12, 64, False, 0, 0),  # the audio tower's S and heads
    (1, 392, 392, 8, 8, 64, False, 0, 0)]    # the IMU's: an 8-row edge tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,q_offset",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(gen, B, Sq, Skv, H, KV, D, causal,
                                        window, q_offset, dtype):
    """dq, dk, dv of the CUDA backward against attention_bwd_reference at
    the same (q, k, v, out, lse, dout), per element within ref.bwd_limit;
    two runs give the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, attention_mask, bwd_limit)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    before = ops.bwd_launches
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert ops.bwd_launches == before + 1
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = attention_bwd_reference(q, k, v, out, lse, do, **kw)
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        err = (g.float() - w.float()).abs()
        assert (err <= bwd_limit(w.float() if dtype == torch.float32
                                 else w)).all(), (name, err.max().item())
    keyless = ~attention_mask(Sq, Skv, **kw).any(1)
    if keyless.any():  # P is 0 there: no gradient to q
        assert (got[0][:, keyless] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,q_offset",
                         FLASH_BWD_CASES)
def test_flash_bwd_kernel_within_float64_gate(gen, B, Sq, Skv, H, KV, D,
                                              causal, window, q_offset,
                                              dtype):
    """dq, dk, dv of the CUDA backward against a float64 backward on the
    same (q, k, v, out, lse, dout): ref.bwd_rel_err, the largest error
    over |g64| + m (m the median |g64| of the nonzero elements), at most
    ref.REL_MULTIPLE = 4 times the plain version's in the same dtype. On
    the CPU over these cases the plain versions read 1e-6 to 2e-5 (f32)
    and 2.5e-3 to 5.4e-3 (bf16, the final rounding: 2^-8 at most); a plain
    version whose sums over D run in another order (a permuted head dim,
    five seeds) read at most 1.6x (f32) and 3.1x (bf16) of it. A floor of
    0.5 m let that reach 3.8x, 0.25 m 5.3x: rounding flips of P and dS in
    elements near 0. This sees what ref.bwd_limit cannot below |g| = 1
    (test_torch_flash_attention.py::test_rel_gate_fails_a_dropped_key_tile)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        REL_MULTIPLE, attention_bwd_reference, bwd_rel_err)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ops.flash_attention_fwd(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    plain = attention_bwd_reference(q, k, v, out, lse, do, **kw)
    g64 = attention_bwd_reference(q, k, v, out, lse, do,
                                  compute_dtype=torch.float64,
                                  grad_dtype=torch.float64, **kw)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, g64):
        err, err_plain = bwd_rel_err(g, w), bwd_rel_err(p, w)
        assert err <= REL_MULTIPLE * err_plain, (name, err, err_plain)


def test_flash_autograd_on_the_card_runs_the_backward_kernel(gen):
    """flash_attention under grad mode: torch.autograd.grad launches the
    backward kernel once and matches the plain version's gradients."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_reference, bwd_limit)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").requires_grad_()
               for s in ((2, 40, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    do = torch.randn((2, 40, 4, 64), generator=gen, device="cuda")
    before = (ops.launches, ops.bwd_launches)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (ops.launches, ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    o, lse = ops.flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                     causal=True)
    want = attention_bwd_reference(q.detach(), k.detach(), v.detach(), o,
                                   lse, do, causal=True)
    for g, w in zip(grads, want):
        assert ((g - w).abs() <= bwd_limit(w)).all()


@pytest.mark.parametrize("shape,dtype", [((33, 1280), torch.bfloat16),
                                         ((5, 7, 64), torch.float32),
                                         ((3001, 1536), torch.float32),
                                         ((257, 80), torch.bfloat16),
                                         ((4096, 1536), torch.bfloat16),
                                         ((8224, 1280), torch.float32)])
def test_rmsnorm_bwd_kernel_matches_plain(gen, shape, dtype):
    """dx per element within ref.bwd_limit's rule (1e-5 at max(|g|, 1) f32,
    one bf16 step bf16); dscale, a sum over rows, within 1e-5 (f32) or one
    bf16 step (bf16) of its largest element; the same bits twice."""
    from repro_torch.kernels.flash_attention.ref import bwd_limit
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_reference
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype) * 3
    s = (torch.rand((shape[-1],), generator=gen, device="cuda")
         + 0.5).to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    before = ops.bwd_launches
    dx, ds = ops.rmsnorm_bwd(x, s, dy)
    assert ops.bwd_launches == before + 1
    dx2, ds2 = ops.rmsnorm_bwd(x, s, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    dx_p, ds_p = rmsnorm_bwd_reference(x, s, dy)
    assert dx.dtype == dtype and ds.dtype == dtype
    assert ((dx.float() - dx_p.float()).abs() <= bwd_limit(dx_p)).all()
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    scale = max(1.0, ds_p.float().abs().max().item())
    assert (ds.float() - ds_p.float()).abs().max().item() <= rel * scale


def test_tower_lora_grads_on_the_card_match_the_cpu(gen):
    """A 2-layer fp32 tower (head dim 64) with a random non-zero LoRA: the
    distillation loss's LoRA gradients through the flash and RMSNorm
    kernels (forward and backward) on the card against the same weights on
    the CPU (the plain versions); one backward launch a layer for flash,
    two a layer for RMSNorm less layer 0's first norm (its input needs no
    gradient) plus the exit head's."""
    from repro_torch.configs.base import MEMConfig, RecallConfig, TowerConfig
    from repro_torch.core import healing as H
    from repro_torch.core import plora
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models import imagebind as IB
    cfg = MEMConfig(towers=(TowerConfig("vision", 2, 128, 2, 256, 40, 48),),
                    embed_dim=64, dtype="float32")
    rc = RecallConfig(exit_interval=1, lora_rank=4)
    params = IB.mem_init(gen, cfg, rc, device="cuda")
    # attention projections at fan-in d: the init takes fan-in H for
    # (d, H, hd) weights, so its attention is near one-hot and the gradient
    # through it amplifies the two paths' fp32 roundoff
    a = params["towers"]["vision"]["layers"]["attn"]
    _, d, n_heads, _ = a["wq"].shape
    for w in ("wq", "wk", "wv"):
        a[w] = a[w] * (n_heads / d) ** 0.5
    a["wo"] = a["wo"] / n_heads ** 0.5
    lora = plora.lora_init(gen, IB.tower_lm_cfg(cfg.tower("vision"), cfg),
                           rc, device="cuda")
    lora = {t: {"a": ab["a"], "b": 0.05 * torch.randn(
        ab["b"].shape, generator=gen, device="cuda")} for t, ab in lora.items()}
    x = torch.randn((3, 40, 48), generator=gen, device="cuda")
    t = torch.nn.functional.normalize(
        torch.randn((3, 64), generator=gen, device="cuda"), dim=-1)
    w = torch.tensor([0.3, 0.7], device="cuda")
    pmask = torch.ones(2, device="cuda")

    def to(tree, dev):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(dev)
        return {k: to(v, dev) for k, v in tree.items()}

    grads = {}
    for dev in ("cuda", "cpu"):
        lp = to(lora, dev)
        leaves = [lp[n][ab].requires_grad_() for n in sorted(lp)
                  for ab in ("a", "b")]
        before = (flash_ops.bwd_launches, rms_ops.bwd_launches)
        loss = H.exit_distill_loss(
            H.tower_exit_embs(to(params, dev), cfg, rc, "vision", x.to(dev),
                              lp), t.to(dev), w.to(dev), pmask.to(dev))
        grads[dev] = torch.autograd.grad(loss, leaves)
        if dev == "cuda":
            assert flash_ops.bwd_launches == before[0] + 2
            assert rms_ops.bwd_launches == before[1] + 2 * 2
    for g, c in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-3, c.abs().max().item())
        assert (g.cpu() - c).abs().max().item() <= 1e-4 * scale


def _guarded_calls():
    """(name, fn(requires_grad) -> call) for each kernel dispatch without
    a backward."""
    from repro_torch.core.quantize import quantize_int4
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.int4_cache import ops as int4_ops
    from repro_torch.kernels.retrieval_topk import ops as topk_ops
    dev = "cuda"

    def g(shape, rg, dtype=torch.float32):
        return torch.randn(shape, device=dev, dtype=dtype).requires_grad_(rg)

    def topk(rg):
        bank = torch.nn.functional.normalize(torch.randn(300, 64, device=dev),
                                             dim=1)
        p, s = quantize_int4(bank)
        return lambda: topk_ops.retrieval_topk_int4(g((2, 64), rg), p, s, 5)

    def gathered(rg):
        bank = torch.randn(300, 64, device=dev)
        p, s = quantize_int4(bank)
        ids = torch.arange(40, device=dev, dtype=torch.int32).repeat(2, 1)
        return lambda: topk_ops.retrieval_topk_int4_gathered(
            g((2, 64), rg), p, s, ids, 5)

    def dense(rg):
        return lambda: topk_ops.retrieval_topk(g((2, 64), rg),
                                               torch.randn(300, 64, device=dev),
                                               5)

    def decode(rg):
        return lambda: decode_attention(
            g((2, 4, 64), rg), torch.randn(2, 32, 2, 64, device=dev),
            torch.randn(2, 32, 2, 64, device=dev),
            torch.tensor([20, 32], dtype=torch.int32, device=dev))

    def quant(rg):
        return lambda: int4_ops.quantize(g((8, 64), rg))

    def dequant(rg):
        p, s = int4_ops.quantize(torch.randn(8, 64, device=dev))
        s = s.clone().requires_grad_(rg)
        return lambda: int4_ops.dequantize(p, s)

    return {"retrieval_topk_int4": (topk, "no gradient in the reference"),
            "retrieval_topk_int4_gathered": (gathered,
                                             "no gradient in the reference"),
            "retrieval_topk": (dense, "no gradient in the reference"),
            "decode_attention": (decode, "no gradient in the reference"),
            "int4_cache.quantize": (quant, "no gradient in the reference"),
            "int4_cache.dequantize": (dequant,
                                      "no gradient in the reference")}


@pytest.mark.parametrize("name", ["retrieval_topk_int4",
                                  "retrieval_topk_int4_gathered",
                                  "retrieval_topk", "decode_attention",
                                  "int4_cache.quantize",
                                  "int4_cache.dequantize"])
def test_kernels_without_backward_raise_under_grad_mode(gen, name):
    """A CUDA dispatch whose kernel has no backward raises, naming why,
    when grad mode is on and an input needs a gradient; under no_grad, or
    with no input that needs one, it launches."""
    make, why = _guarded_calls()[name]
    with pytest.raises(NotImplementedError, match=why):
        make(True)()
    with torch.no_grad():
        make(True)()
    make(False)()
    torch.cuda.synchronize()


def test_embed_lookup_backward_is_deterministic_and_within_a_bf16_step(gen):
    """The embedding table's gradient on the card (qwen2's table width, a
    batch of 4,096 ids drawn from 300 rows, so rows repeat): the same bits
    twice, and within one bf16 step of each element of a float64
    scatter-add of the same cotangents (the float32 sum's own error is far
    below that; the one rounding is the cast to bf16)."""
    from repro_torch.models import layers as L
    table = torch.randn((1000, 1536), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    ids = torch.randint(0, 300, (2, 2048), generator=gen, device="cuda")
    g = torch.randn((2, 2048, 1536), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = L.embed_lookup(table, ids)
    d1, = torch.autograd.grad(out, table, g, retain_graph=True)
    d2, = torch.autograd.grad(out, table, g)
    assert d1.dtype == torch.bfloat16 and torch.equal(d1, d2)
    want = torch.zeros((1000, 1536), dtype=torch.float64, device="cuda")
    want.index_add_(0, ids.reshape(-1), g.double().reshape(-1, 1536))
    step = 2.0 ** -8 * want.abs()  # one bf16 step of each element
    assert ((d1.double() - want).abs() <= step).all()
    assert (d1[300:] == 0).all()


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev)
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, dev) for x in tree))
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree


def test_lm_train_step_on_the_card_matches_the_cpu(gen):
    """Two train steps of a small fp32 dense LM (head dim 64, GQA 2:1, tied
    head; two microbatches, remat) on the card (flash and rmsnorm forward
    and backward kernels) against the same weights and batches on the CPU:
    losses and grad norms within 1e-4; params within 1e-4 of each leaf's
    scale or 10 % of the first step's lr; moments within 1e-4 of each
    leaf's scale but for at most 5 % of its elements (each microbatch's
    gradient is rounded to bf16, and the two paths' fp32 noise can send an
    element at a rounding tie to either neighbour: tests/test_torch_train.py
    measures the same against the reference); the kernels' launches a step
    exact."""
    from repro_torch.configs.base import (ArchSpec, LMConfig, RecallConfig,
                                          ShapeConfig)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamW, _leaves
    cfg = LMConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   d_head=64, d_ff=256, vocab=300, rope_theta=1e4,
                   qkv_bias=True, tie_embeddings=True, dtype="float32")
    spec = ArchSpec("t", "lm", cfg, (ShapeConfig("t", "train", 4, 48),),
                    RecallConfig(exit_interval=1))
    params = T.lm_init(gen, cfg, spec.recall, device="cuda")
    a = params["layers"]["attn"]  # at fan-in d, as the CPU tests take it
    for w in ("wq", "wk", "wv"):
        a[w] = a[w] * (cfg.n_heads / cfg.d_model) ** 0.5
    a["wo"] = a["wo"] / cfg.n_heads ** 0.5
    toks = torch.randint(0, cfg.vocab, (2, 4, 49), generator=gen,
                         device="cuda")
    runs = {}
    for dev in ("cuda", "cpu"):
        bundle = S.build_step(spec, spec.shapes[0], device=dev,
                              microbatches=2)
        p, o = _to(params, dev), AdamW().init(_to(params, dev))
        losses = []
        for i in range(2):
            before = (flash_ops.launches, flash_ops.bwd_launches,
                      rms_ops.launches, rms_ops.bwd_launches)
            p, o, m = bundle.fn(p, o, {"tokens": toks[i, :, :-1].to(dev),
                                       "labels": toks[i, :, 1:].to(dev)})
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            if dev == "cuda":  # a microbatch: L layers, remat, final norm
                L = cfg.n_layers
                assert (flash_ops.launches - before[0],
                        flash_ops.bwd_launches - before[1],
                        rms_ops.launches - before[2],
                        rms_ops.bwd_launches - before[3]) == \
                    (2 * 2 * L, 2 * L, 2 * (4 * L + 1), 2 * (2 * L + 1))
        runs[dev] = (losses, p, o)
    (lc, pc, oc), (lp, pp, op) = runs["cuda"], runs["cpu"]
    for got, want in zip(lc, lp):
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-4 * abs(w)
    for g, w in zip(_leaves(pc), _leaves(pp)):
        tol = max(1e-4 * w.abs().max().item(), 0.1 * 1.5e-5)
        assert (g.cpu() - w).abs().max().item() <= tol
    for g, w in zip(_leaves(oc.m) + _leaves(oc.v), _leaves(op.m)
                    + _leaves(op.v)):
        far = (g.cpu() - w).abs() > 1e-4 * max(w.abs().max().item(), 1e-30)
        assert far.float().mean().item() <= 0.05


def test_bf16_checkpoint_round_trip_from_the_card(gen, tmp_path):
    """bf16 params and fp32 Adam moments on the card through
    ``Checkpointer``: back on the card bit for bit, the step an int."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim.adamw import AdamW
    params = {"w": torch.randn((64, 48), generator=gen, device="cuda").to(
        torch.bfloat16), "b": {"c": torch.randn(
            7, generator=gen, device="cuda").to(torch.bfloat16)}}
    opt = AdamW().init(params)
    opt = opt._replace(step=3, m={"w": torch.randn((64, 48), generator=gen,
                                                   device="cuda"),
                                  "b": {"c": torch.randn(7, generator=gen,
                                                         device="cuda")}})
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, {"params": params, "opt": opt})
    ck.wait()
    like = {"params": _to(params, "cpu"), "opt": _to(opt, "cpu")}
    r, man = ck.restore(like, device="cuda")
    assert r["opt"].step == 3 and man["leaves"]["params/w"]["dtype"] == \
        "bfloat16"
    for got, want in ((r["params"]["w"], params["w"]),
                      (r["params"]["b"]["c"], params["b"]["c"]),
                      (r["opt"].m["w"], opt.m["w"])):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype ==
                           torch.bfloat16 else want)


def test_rmsnorm_kernel_at_the_gnn_exit_width_matches_plain(gen):
    """The Triton RMSNorm at GatedGCN's exit head: 8 exits of width 70,
    fp32 (a width that is no power of two), one launch, within 1e-5 of
    the plain version."""
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference
    x = torch.randn((8, 70), generator=gen, device="cuda") * 3
    scale = 1 + 0.1 * torch.randn((70,), generator=gen, device="cuda")
    before = ops.launches
    out = ops.rmsnorm_fwd(x, scale, 1e-5)
    assert ops.launches == before + 1
    want = rmsnorm_reference(x, scale, 1e-5)
    assert (out - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("arch", ["dien", "gatedgcn"])
def test_family_train_step_gives_the_same_bits_twice(gen, arch):
    """A recsys (DIEN's smoke variant at batch 2,048) and a GNN (the
    GatedGCN smoke graph) train step on the card, run twice from copies of
    one state on one batch: the same loss, grad norm, params and moments,
    bit for bit (the gathers' gradients and the segment sums add in a
    fixed order)."""
    import numpy as np
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_variant
    from repro_torch.data import synthetic as SYN
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TR
    from repro_torch.models.gnn import Graph
    from repro_torch.optim.adamw import AdamW, _leaves
    spec = smoke_variant(get_arch(arch))
    if arch == "dien":
        shape = ShapeConfig("t", "train", global_batch=2048)
        b = S.build_step(spec, shape, device="cuda")
        data = TR.make_train_data(spec, shape, 2048, 0)
        inputs = {k: torch.as_tensor(v).cuda() for k, v in data.items()
                  if k in b.meta["inputs"]}
    else:
        shape = spec.shape("smoke_graph")
        b = S.build_step(spec, shape, device="cuda")
        g = SYN.sbm_graph(0, 64, 5, 8, avg_degree=2.0)
        E, e = 256, len(g["src"])
        pad = lambda a: np.concatenate([a, np.zeros(E - e, a.dtype)])
        inputs = Graph(*[torch.as_tensor(a).cuda() for a in (
            g["node_feat"], pad(g["src"]), pad(g["dst"]),
            np.ones(64, np.float32), pad(np.ones(e, np.float32)),
            g["labels"])])
    params = TR.init_params(spec, 0, "cuda", shape)
    runs = []
    for _ in range(2):
        p = _copy(params)
        p, o, m = b.fn(p, AdamW().init(p), inputs)
        runs.append((m["loss"].item(), m["grad_norm"].item(),
                     _leaves(p) + _leaves(o.m) + _leaves(o.v)))
    assert runs[0][:2] == runs[1][:2]
    assert all(torch.equal(x, y) for x, y in zip(runs[0][2], runs[1][2]))


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return {k: _copy(v) for k, v in tree.items()}


# the mesh and sharding layer: a mesh's entries all cuda:0, held to the
# same calls on CPU entries


def _bits(x):
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_mesh_placement_and_elastic_restore_on_the_card(gen, tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import get_arch, smoke_variant
    from repro_torch.distributed import mesh_utils as M
    from repro_torch.distributed.elastic import (elastic_restore,
                                                 survivors_mesh)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    spec = smoke_variant(get_arch("qwen2-1.5b"))
    cfg, rc = spec.model, spec.recall
    params = T.lm_init(gen, cfg, rc, device="cuda")
    rules, specs = M.lm_rules(False), T.lm_specs(cfg, rc)
    ab = T.lm_abstract(cfg, rc)
    placed, on_cpu = (M.place_tree(tree, M.make_shardings(
        specs, make_mesh((2, 2), ("data", "model"), [dev] * 4), rules, ab))
        for tree, dev in ((params, "cuda:0"),
                          (M.tree_map(lambda x: x.cpu(), params), "cpu")))
    for (name, st), (_, ct) in zip(_items(placed), _items(on_cpu)):
        assert all(p.is_cuda for p in st.pieces)
        assert len({p.data_ptr() for p in st.pieces}) == 4
        for p, c in zip(st.pieces, ct.pieces):
            assert torch.equal(_bits(p.cpu()), _bits(c)), name
    ck = Checkpointer(str(tmp_path))
    ck.save(1, placed)
    surv = survivors_mesh(["cuda:0"] * 4, (2, 2), ("data", "model"),
                          failed=2)
    assert surv.shape == {"data": 1, "model": 2}
    back, _ = elastic_restore(ck, ab, surv, rules, specs)
    for (name, x), (_, st) in zip(_items(params), _items(back)):
        assert all(p.is_cuda for p in st.pieces)
        assert torch.equal(_bits(st.gather()), _bits(x)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_seqparallel_on_the_card(gen, dtype):
    from repro_torch.distributed import mesh_utils as M
    from repro_torch.distributed.collectives import flash_decode_seqparallel
    from repro_torch.kernels.decode_attention.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attention.ref import bf16_rounding_limit
    from repro_torch.launch.mesh import make_mesh
    B, S, H, KV, D, n = 4, 1024, 8, 2, 128, 4
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([100, 1024, 0, 700], dtype=torch.int32,
                        device="cuda")
    outs = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_mesh((n,), ("seq",), [dev] * n)
        cut = M.NamedSharding(mesh, (None, "seq"))
        o = flash_decode_seqparallel(mesh, "seq")(
            q.to(dev), cut.shard(k), cut.shard(v), lens.to(dev))
        assert all(x.device.type == dev[:4] for x in o)
        outs[dev] = o[0].cpu().float()
    ker = decode_attn_cuda(q, k, v, lens).cpu().float()
    if dtype == torch.float32:
        assert (outs["cuda:0"] - outs["cpu"]).abs().max().item() <= 1e-5
        lim = 1e-5 * torch.clamp_min(ker.abs(), 1.0)
    else:
        assert bool(((outs["cuda:0"] - outs["cpu"]).abs()
                     <= bf16_rounding_limit(outs["cpu"])).all())
        lim = bf16_rounding_limit(ker)
    live = lens.cpu() > 0
    assert bool(((outs["cuda:0"] - ker).abs() <= lim)[live].all())


def test_gradient_collectives_on_the_card_equal_the_cpu(gen):
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     psum_scatter_tree)
    shapes = {"a": (64, 48), "b": (7, 3), "c": (), "d": (256,),
              "e": (8, 4, 6)}

    def draw():
        return {k: torch.randn(s, generator=gen, device="cuda") * 1e-2
                for k, s in shapes.items()}
    cpu = lambda tree: {k: v.cpu() for k, v in tree.items()}
    g1, g2 = [draw(), draw()], [draw(), draw()]
    s1, e1 = compressed_psum(g1)
    s2, e2 = compressed_psum(g2, e1)
    c1, ce1 = compressed_psum([cpu(t) for t in g1])
    c2, ce2 = compressed_psum([cpu(t) for t in g2], ce1)
    for got, want in ((s1, c1), (e1, ce1), (s2, c2), (e2, ce2)):
        for gt, wt in zip(got, want):
            for k in shapes:
                assert gt[k].is_cuda
                assert torch.equal(_bits(gt[k].cpu()), _bits(wt[k])), k
    gs = [draw() for _ in range(4)]
    got = psum_scatter_tree(gs)
    want = psum_scatter_tree([cpu(t) for t in gs])
    for gt, wt in zip(got, want):
        for k in shapes:
            assert torch.equal(_bits(gt[k].cpu()), _bits(wt[k])), k


# M, d, d_ff of the split GEMMs: the vision tower's widths at one exit row
# group (257 = 2 x 128 + 1 rows: a ragged last tile) and three, K past
# many 32-deep stages; N not a multiple of the 64- or 128-column tile (d_ff
# 200, d 72); K under one stage (8); one row; many tiles a block (M 4,000
# at d_ff 5,120: 32 x 80 gate/up tiles over 132 blocks)
@pytest.mark.parametrize("M,d,d_ff", [
    (257, 1280, 512), (771, 256, 1280), (37, 72, 200), (1, 8, 8),
    (4000, 1280, 5120)])
def test_split_gemm_kernels_match_plain(gen, M, d, d_ff):
    """Both kernels against the plain version and a float64 product: the
    worst error against float64 within 2x fp32 cuBLAS's (TF32 off) plus
    half an fp32 step of the output's scale (small K leaves cuBLAS exact);
    the same bits twice; each launch counted."""
    import torch.nn.functional as F
    from repro_torch.kernels.split_gemm import ops, ref
    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.randn((M, d), generator=gen, device="cuda")
    wg, wu = ((torch.randn((d, d_ff), generator=gen, device="cuda")
               * d ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((d_ff, d), generator=gen, device="cuda")
          * d_ff ** -0.5).bfloat16()
    before = dict(ops.launches_by_kernel)
    h = ops.swiglu_gate_up(x, wg, wu)
    y = ops.matmul(h, wd)
    assert ops.launches_by_kernel.get("gate_up", 0) == \
        before.get("gate_up", 0) + 1
    assert ops.launches_by_kernel.get("down", 0) == before.get("down", 0) + 1
    assert torch.equal(h, ops.swiglu_gate_up(x, wg, wu))
    assert torch.equal(y, ops.matmul(h, wd))
    x64 = x.double()
    for got, plain, lib, exact in (
            (h, ref.swiglu_gate_up(x, wg, wu),
             F.silu(x @ wg.float()) * (x @ wu.float()),
             F.silu(x64 @ wg.double()) * (x64 @ wu.double())),
            (y, ref.matmul(h, wd), h @ wd.float(),
             h.double() @ wd.double())):
        assert got.shape == exact.shape and got.dtype == torch.float32
        err, err_lib = ((t.double() - exact).abs().max().item()
                        for t in (got, lib))
        floor = 2.0 ** -24 * exact.abs().max().item()
        assert err <= 2 * err_lib + floor, (err, err_lib)
        assert (got - plain).abs().max().item() <= \
            2 * err_lib + 2 * (plain.double() - exact).abs().max().item() \
            + floor


@pytest.mark.parametrize("which", ["gate_up", "down"])
def test_split_gemm_kernels_propagate_non_finite(gen, which):
    """inf and NaN in x (a NaN whose payload lies below bit 16 too) land
    where fp32 cuBLAS puts them."""
    import torch.nn.functional as F
    from repro_torch.kernels.split_gemm import ops
    d, N = 64, 136
    x = torch.randn((300, d), generator=gen, device="cuda")
    x[1, 3], x[2, 0], x[3, 5] = float("inf"), float("-inf"), float("nan")
    x[4, 1], x[4, 2] = float("inf"), float("-inf")
    x[5, 7] = torch.tensor([0x7F800001], dtype=torch.int32,
                           device="cuda").view(torch.float32)
    wg, wu = ((torch.randn((d, N), generator=gen, device="cuda")
               * d ** -0.5).bfloat16() for _ in range(2))
    if which == "down":
        got, want = ops.matmul(x, wg), x @ wg.float()
    else:
        got = ops.swiglu_gate_up(x, wg, wu)
        want = F.silu(x @ wg.float()) * (x @ wu.float())
    for f in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(f(got), f(want)), f
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max().item() <= 1e-4


# MLA's forward (flash_fwd_mla: q/k 192, v 128, bf16, causal): the
# moonlight.prefill_8k cell's attention at one of its prompts (B 1 of 8, S
# 8,192, 16 heads; the plain version's scores take 4.3 GB), a ragged
# length (S 1,000: a partial last q and key tile) and a small batch with
# q_offset; held per element to the plain variant that rounds P as the
# kernel does, within one bf16 step at max(|o|, 1) (ref.bf16_step_limit),
# the lse within 1e-4
MLA_CASES = [(1, 8192, 16, True, 0), (2, 1000, 16, True, 0),
             (2, 77, 4, True, 51), (2, 300, 2, False, 0)]


@pytest.mark.parametrize("B,S,H,causal,q_offset", MLA_CASES)
def test_flash_mla_kernel_matches_plain(gen, B, S, H, causal, q_offset):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import plain_like_kernel
    from repro_torch.kernels.flash_attention.ref import bf16_step_limit
    bf = torch.bfloat16
    q = torch.randn((B, S, H, 192), generator=gen, device="cuda").to(bf)
    k = torch.randn((B, S, H, 192), generator=gen, device="cuda").to(bf)
    v = torch.randn((B, S, H, 128), generator=gen, device="cuda").to(bf)
    kw = dict(causal=causal, q_offset=q_offset)
    before = ops.launches_by_head_dim.get(192, 0)
    o, lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert ops.launches_by_head_dim[192] == before + 1
    assert o.shape == (B, S, H, 128)
    o_p, lse_p = plain_like_kernel(q, k, v, **kw)
    assert ((o.float() - o_p.float()).abs() <= bf16_step_limit(o_p)).all()
    assert (lse - lse_p).abs().max().item() <= 1e-4


def test_flash_mla_backward_raises(gen):
    from repro_torch.kernels.flash_attention import ops
    q, k = (torch.randn((1, 64, 2, 192), generator=gen, device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    v = torch.randn((1, 64, 2, 128), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    o = ops.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="MLA"):
        o.float().sum().backward()


def test_moonlight_prefill_and_decode_at_published_widths(gen):
    """moonlight-16b-a3b whole (27 layers, 15.96e9 bf16 parameters drawn as
    the benchmark draws them): a prefill of 2 x 1,024 through build_step
    (the MLA kernel, the dropless MoE on the grouped GEMMs), then 4 decode
    steps through the latent cache on 4 more seeded tokens, their logits
    against the float32 reference's full forward pass over all 1,028
    (the benchmark's modules come from the checkout's root, the cwd of
    ``python -m pytest``)."""
    from bench.drivers.mla_prefill import mla_spec
    from bench.lib import weights as W
    from bench.reference import moonlight as RM
    from bench.harness import load_json, ROOT
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import build_step
    from repro_torch.models.transformer import lm_schema
    c = load_json(ROOT / "bench/configs/moonlight-16b-a3b.json")
    spec = get_arch("moonlight-16b-a3b")
    assert spec.model == mla_spec(c).model   # the registered arch is the file's
    torch.backends.cuda.matmul.allow_tf32 = False
    params = W.make_params(lm_schema(spec.model, spec.recall), seed=5,
                           dtype=torch.bfloat16, device="cuda")
    B, S, n = 2, 1024, 4
    seq = torch.randint(0, c["vocab_size"], (B, S + n), generator=gen,
                        device="cuda")
    pre = build_step(spec, ShapeConfig("p", "prefill", B, S), device="cuda",
                     pad_to=S + n).fn
    dec = build_step(spec, ShapeConfig("d", "decode", B, S + n),
                     device="cuda").fn
    before = ops.launches_by_head_dim.get(192, 0)
    with torch.no_grad():
        latent = pre(params, seq[:, :S])["latent_cache"]
        assert ops.launches_by_head_dim[192] == before + 27
        got = []
        for i in range(n):      # the token at position S + i
            lengths = torch.full((B,), S + i + 1, dtype=torch.int32,
                                 device="cuda")
            logits, latent = dec(params, seq[:, S + i], latent, lengths)
            got.append(logits)
        ref = RM.logits(params, seq, c)[:, S:]
    out = torch.stack(got, 1)
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= MOONLIGHT_LOGIT_LIMIT, rel


# bf16 activations and weights through 27 layers against float32: the
# logits' relative error (Frobenius) read 1.72e-2 and 1.83e-2 on the card
# (seeds 5, 6); the float32 reference with its products in fp8 e4m3 read
# 0.255 and 0.277 against itself. 0.06 sits 3.3x above the one and 4x
# below the other.
MOONLIGHT_LOGIT_LIMIT = 0.06


# the KDA chunked kernel (kernels/kda/csrc/kda_fwd.cu) against the plain
# chunked version, which repeats its arithmetic in torch (``tf32``: the
# products' operands rounded to TF32 as the tensor cores take them): the
# kimi_linear.prefill_16k cell's shape (B 4, S 16,384, 32 heads of 128),
# a ragged S with an initial state, S under one chunk, and strong decay
# (A_log = log 16). o within two bf16 steps of the largest |o|: each side
# sums in fp32 in its own order and rounds once to bf16; the final state
# within 1e-3 relative: fp32 through S / 64 chunk steps in another order,
# where an operand that the two orders leave on either side of a TF32
# rounding boundary rounds one TF32 step (2^-11) apart (the card read up
# to 2.9e-4 at S 4,096 with weak decay and an initial state)
KDA_CASES = [(4, 16384, 32, 0.0, False), (1, 1000, 4, -4.0, True),
             (2, 37, 3, 0.0, True), (2, 300, 8, 2.772588722239781, False)]


def _kda_inputs(B, S, H, a_log, init, gen):
    import math
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = F.normalize(r(B, S, H, 128), dim=-1).bfloat16()
    k = F.normalize(r(B, S, H, 128), dim=-1).bfloat16()
    v = r(B, S, H, 128).bfloat16()
    g = -math.exp(a_log) * F.softplus(r(B, S, H, 128))
    beta = torch.sigmoid(r(B, S, H))
    return q, k, v, g, beta, (r(B, H, 128, 128) if init else None)


@pytest.mark.parametrize("B,S,H,a_log,init", KDA_CASES)
def test_kda_kernel_matches_plain(gen, B, S, H, a_log, init):
    from repro_torch.kernels.kda import ops
    from repro_torch.kernels.kda.ref import kda_chunked
    q, k, v, g, beta, s0 = _kda_inputs(B, S, H, a_log, init, gen)
    before = ops.read_counters()
    o, st = ops.kda_chunk(q, k, v, g, beta, scale=128 ** -0.5,
                          initial_state=s0)
    after = ops.read_counters()
    assert after["launches"] == before["launches"] + 1
    assert after["tokens"] == before["tokens"] + B * S * H
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    po, pst = kda_chunked(q, k, v, g, beta, scale=128 ** -0.5,
                          initial_state=s0, tf32=True)
    lim = 2.0 ** -7 * po.float().abs().max().item()
    assert (o.float() - po.float()).abs().max().item() <= lim
    rel = torch.linalg.vector_norm(st - pst) / torch.linalg.vector_norm(pst)
    assert rel.item() <= 1e-3


def test_kda_kernel_gives_the_same_bits_twice(gen):
    from repro_torch.kernels.kda.kernel import kda_fwd_cuda
    q, k, v, g, beta, s0 = _kda_inputs(2, 700, 8, -1.0, True, gen)
    a = kda_fwd_cuda(q, k, v, g, beta, scale=0.1, initial_state=s0)
    b = kda_fwd_cuda(q, k, v, g, beta, scale=0.1, initial_state=s0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kda_kernel_refuses_a_gradient_and_other_widths(gen):
    from repro_torch.kernels.kda import ops
    q, k, v, g, beta, _ = _kda_inputs(1, 64, 2, 0.0, False, gen)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.kda_chunk(q, k, v, g, beta, scale=0.1)
    with torch.no_grad(), pytest.raises(ValueError, match="128"):
        ops.kda_chunk(q[..., :64], k[..., :64], v[..., :64], g[..., :64],
                      beta, scale=0.1)


def test_kimi_linear_prefill_and_decode_at_published_widths(gen):
    """kimi-linear-48b-a3b at its published widths, cut to the benchmark's
    stage (layers 1-12: 9 KDA, 3 NoPE MLA, 11 MoE layers of 256 experts;
    21.28e9 bf16 parameters drawn as the benchmark draws them): a prefill
    of 2 x 1,024 through build_step (the KDA kernel, flash_fwd_mla, the
    dropless MoE), then 2 decode steps through the latent cache, the KDA
    states and the conv tails on 2 more seeded tokens, their logits
    against the float32 reference's full forward pass over all 1,026."""
    from bench.drivers.kda_prefill import kda_spec
    from bench.lib import weights as W
    from bench.reference import kimi_linear as RK
    from bench.harness import load_json, ROOT
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels.flash_attention import ops as FOPS
    from repro_torch.kernels.kda import ops as KOPS
    from repro_torch.launch.steps import build_step
    from repro_torch.models.attention import cache_names
    from repro_torch.models.transformer import lm_schema
    c = load_json(ROOT / "bench/configs/kimi-linear-48b-a3b.json")
    spec = kda_spec(c)
    m27 = get_arch("kimi-linear-48b-a3b").model
    # the registered arch is the file's, cut to the stage
    assert spec.model == dataclasses.replace(
        m27, n_layers=12, kda_layers=tuple(i for i in m27.kda_layers
                                           if i < 12))
    torch.backends.cuda.matmul.allow_tf32 = False
    params = W.make_params(lm_schema(spec.model, spec.recall), seed=5,
                           dtype=torch.bfloat16, device="cuda")
    B, S, n = 2, 1024, 2
    seq = torch.randint(0, c["vocab_size"], (B, S + n), generator=gen,
                        device="cuda")
    pre = build_step(spec, ShapeConfig("p", "prefill", B, S), device="cuda",
                     pad_to=S + n).fn
    dec = build_step(spec, ShapeConfig("d", "decode", B, S + n),
                     device="cuda").fn
    flash0, kda0 = FOPS.launches_by_head_dim.get(192, 0), \
        KOPS.read_counters()["launches"]
    with torch.no_grad():
        out = pre(params, seq[:, :S])
        assert FOPS.launches_by_head_dim[192] == flash0 + 3
        assert KOPS.read_counters()["launches"] == kda0 + 9
        caches = [out[k] for k in cache_names(spec.model)]
        got = []
        for i in range(n):      # the token at position S + i
            lengths = torch.full((B,), S + i + 1, dtype=torch.int32,
                                 device="cuda")
            logits, *caches = dec(params, seq[:, S + i], *caches, lengths)
            got.append(logits)
        del out, caches
        ref = RK.logits(params, seq, c)[:, S:]
    out = torch.stack(got, 1)
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"kimi-linear logits rel {rel:.4e}")
    assert rel <= KIMI_LOGIT_LIMIT, rel


# bf16 activations and weights through 12 layers against float32: the
# logits' relative error (Frobenius) read 2.84e-2 and 2.65e-2 on the card
# (seeds 5, 6); the float32 reference with its products in fp8 e4m3 read
# 0.332 and 0.316 against itself. 0.09 sits 3.2x above the one and 3.5x
# below the other.
KIMI_LOGIT_LIMIT = 0.09
