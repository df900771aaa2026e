"""Port parity: the grouped expert GEMM's sort/pad plan equals the
reference's, and the port's moe_gemm (plan + the plain sorted version on
the CPU) equals the reference's Pallas path (interpret mode) and its
oracle; its backward's plain versions equal autograd of the plain forward
and ``jax.vjp`` of the reference's oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ops import moe_gemm as jax_moe_gemm
from repro.kernels.moe_gemm.ops import sort_by_expert as jax_sort_by_expert
from repro.kernels.moe_gemm.ref import moe_gemm_reference as jax_reference
from repro_torch.kernels.moe_gemm import kernel as MK
from repro_torch.kernels.moe_gemm import ops as MO
from repro_torch.kernels.moe_gemm.ref import (moe_gemm_reference,
                                              moe_gemm_sorted_dw_reference,
                                              moe_gemm_sorted_dx_reference,
                                              moe_gemm_sorted_reference)
from torch.nn import functional as F


def _ids(kind, T, E, seed):
    rng = np.random.default_rng(seed)
    if kind == "one_expert":
        return np.full(T, min(3, E - 1), np.int32)
    if kind == "empty_experts":  # only even experts are used
        return (2 * rng.integers(0, (E + 1) // 2, T)).astype(np.int32)
    return rng.integers(0, E, T).astype(np.int32)


@pytest.mark.parametrize("kind,E,T,bt", [
    ("random", 2, 10, 8), ("random", 6, 200, 64), ("random", 4, 64, 16),
    ("one_expert", 8, 128, 32), ("empty_experts", 8, 77, 16),
    ("random", 128, 128, 16), ("random", 128, 16384, 128),
    ("one_expert", 16, 2048, 128)])
def test_plan_matches_reference(kind, E, T, bt):
    eid = _ids(kind, T, E, seed=E * T + bt)
    order, slot, block_expert, T_pad = jax_sort_by_expert(jnp.asarray(eid),
                                                          E, bt)
    t = MO.sort_by_expert(torch.from_numpy(eid), E, bt)
    assert t[3] == T_pad
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(order))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(slot))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(block_expert))
    assert t[2].dtype == torch.int32 and t[1].dtype == torch.int32
    p = MO.plan(torch.from_numpy(eid), E, bt)
    counts = np.bincount(eid, minlength=E)
    assert int(p.used) == int((-(-counts // bt) * bt).sum())


CASES = [  # T, d, E, F, bt, ids
    (300, 64, 8, 128, 32, "random"),     # the reference's kernel cases
    (64, 32, 4, 64, 16, "random"),
    (1000, 128, 16, 256, 64, "random"),
    (128, 16, 8, 32, 32, "one_expert"),  # all tokens on one expert
    (77, 40, 8, 768, 16, "empty_experts"),  # F = 768, T not a multiple
]


@pytest.mark.parametrize("T,d,E,F,bt,kind", CASES)
def test_moe_gemm_matches_reference_pallas(T, d, E, F, bt, kind):
    rng = np.random.default_rng(T + d)
    x = rng.standard_normal((T, d)).astype(np.float32)
    eid = _ids(kind, T, E, seed=T)
    w = (rng.standard_normal((E, d, F)) * 0.1).astype(np.float32)
    want = np.asarray(jax_reference(jnp.asarray(x), jnp.asarray(eid),
                                    jnp.asarray(w)))
    if F % min(64, F) == 0:  # the Pallas kernel asserts F % block_f == 0
        pal = np.asarray(jax_moe_gemm(jnp.asarray(x), jnp.asarray(eid),
                                      jnp.asarray(w), impl="pallas",
                                      block_t=bt, block_f=min(64, F)))
        np.testing.assert_allclose(pal, want, atol=1e-4)
    tx, te, tw = (torch.from_numpy(a) for a in (x, eid, w))
    before = MO.launches
    got = MO.moe_gemm(tx, te, tw, block_t=bt).numpy()
    assert MO.launches == before  # a CPU tensor launches no kernel
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(moe_gemm_reference(tx, te, tw).numpy(), want,
                               atol=1e-4)
    np.testing.assert_allclose(MO.moe_gemm(tx, te, tw).numpy(), want,
                               atol=1e-4)  # the automatic token block


def test_sorted_plain_version_leaves_unused_rows_zero():
    rng = np.random.default_rng(3)
    eid = torch.from_numpy(_ids("empty_experts", 50, 8, seed=3))
    x = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 16, 24)).astype(np.float32))
    p = MO.plan(eid, 8, 16)
    xs = MO.scatter_rows(x, p)
    ys = moe_gemm_sorted_reference(xs, p.block_expert, w, 16, p.used)
    assert ys.shape == (p.T_pad, 24)
    assert not ys[int(p.used):].any()
    be = p.block_expert.long().repeat_interleave(16)[:int(p.used)]
    want = torch.einsum("td,tdf->tf", xs[:int(p.used)], w[be])
    torch.testing.assert_close(ys[:int(p.used)], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,d,E,F_,bt,kind", [
    (100, 32, 8, 1408, 16, "random"),        # Moonlight's F, decode blocks
    (300, 24, 4, 1408, 64, "empty_experts"),  # F 1,408 at the wgmma block
    (700, 16, 4, 768, 128, "random"),        # qwen3-moe's F, prefill block
    (77, 40, 8, 768, 64, "one_expert")])
def test_sorted_swiglu_plain_version_is_the_three_steps(T, d, E, F_, bt,
                                                         kind):
    """``moe_gemm_sorted_swiglu`` on the CPU is, bit for bit, the MoE
    layer's three steps on bf16 rows: gate and up through the plain sorted
    product, then ``F.silu(g.float()).to(bf16) * u``; rows from ``used`` on
    (T leaves padding rows) are 0; no kernel is launched, and
    ``swiglu_takes`` sends no CPU tensor to the fused kernel."""
    bf = torch.bfloat16
    rng = np.random.default_rng(T + F_)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    wg, wu = (torch.from_numpy((rng.standard_normal((E, d, F_)) * d ** -0.5)
                               .astype(np.float32)).to(bf) for _ in range(2))
    p = MO.plan(torch.from_numpy(_ids(kind, T, E, seed=T)), E, bt)
    xs = MO.scatter_rows(x.to(bf), p)
    n = int(p.used)
    assert n < p.T_pad
    g = moe_gemm_sorted_reference(xs, p.block_expert, wg, bt, p.used)
    u = moe_gemm_sorted_reference(xs, p.block_expert, wu, bt, p.used)
    want = F.silu(g.float()).to(bf) * u
    before = (MO.launches, dict(MO.launches_by_kernel))
    h = MO.moe_gemm_sorted_swiglu(xs, p.block_expert, wg, wu, bt, p.used)
    assert (MO.launches, MO.launches_by_kernel) == before
    assert h.dtype == bf and h.shape == (p.T_pad, F_)
    assert torch.equal(h, want)
    assert not h[n:].any() and h[:n].any()
    assert not MO.swiglu_takes(xs, wg, wu, bt)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_gemm_swiglu_cuda(xs, p.block_expert, wg, wu, bt, p.used)


def test_block_t_for():
    assert MO.block_t_for(131072, 128) == 128  # a prefill's assignments
    assert MO.block_t_for(12000, 128) == 64    # a short prefill's
    assert MO.block_t_for(128, 128) == 16      # a decode step's


@pytest.mark.parametrize("dtype,bt,d,F,want", [
    (torch.bfloat16, 128, 2048, 768, "wgmma"),    # qwen3-moe prefill
    (torch.bfloat16, 128, 768, 2048, "wgmma"),    # its down projection
    (torch.bfloat16, 64, 2048, 1408, "wgmma"),
    (torch.bfloat16, 16, 2048, 768, "mma_sync"),  # a decode step
    (torch.float32, 128, 2048, 768, "mma_sync"),  # f32
    (torch.bfloat16, 64, 200, 100, "mma_sync"),   # F % 8: no TMA stride
    (torch.bfloat16, 128, 36, 768, "mma_sync"),   # d % 8
    (torch.bfloat16, 32, 2048, 768, "mma_sync"),
    # dW takes kernel_for(xs's dtype, bt, xs's width, dys's width) too
    (torch.bfloat16, 128, 256, 96, "wgmma"),      # dW: a partial F tile
    (torch.bfloat16, 64, 320, 1408, "wgmma"),     # dW: ragged d and F tiles
    (torch.float32, 128, 768, 2048, "mma_sync"),  # f32 dW of the down
    (torch.bfloat16, 16, 768, 2048, "mma_sync")])
def test_kernel_for(dtype, bt, d, F, want):
    assert MK.kernel_for(dtype, bt, d, F) == want
    assert want in MK.KERNELS


def test_kernel_wrapper_refuses_cpu_tensors():
    p = MO.plan(torch.zeros(4, dtype=torch.int32), 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_gemm_cuda(torch.zeros((p.T_pad, 8)), p.block_expert,
                         torch.zeros((2, 8, 8)), 16, p.used)


@pytest.mark.parametrize("dtype,bt,d,F", [
    (torch.bfloat16, 128, 2048, 768),   # a train microbatch's gate/up
    (torch.bfloat16, 128, 768, 2048),   # its down projection
    (torch.float32, 64, 256, 96)])
def test_dw_wrapper_refuses_cpu_tensors(dtype, bt, d, F):
    """``moe_gemm_dw_cuda`` launches on CUDA tensors only, whichever kernel
    the shape takes (it never falls back to the plain version)."""
    p = MO.plan(torch.zeros(4, dtype=torch.int32), 2, bt)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_gemm_dw_cuda(torch.zeros((p.T_pad, d), dtype=dtype),
                            torch.zeros((p.T_pad, F), dtype=dtype), p.ends,
                            bt, p.used)


@pytest.mark.parametrize("dtype,bt,d,F", [
    (torch.bfloat16, 16, 2048, 768),    # a decode step's 16-row blocks
    (torch.float32, 128, 2048, 768),    # f32
    (torch.bfloat16, 128, 36, 768),     # d % 8: no TMA stride
    (torch.bfloat16, 64, 256, 100)])    # F % 8
def test_dw_wrapper_refuses_wgmma_where_kernel_for_does_not_give_it(
        dtype, bt, d, F):
    """``kernel="wgmma"`` is refused for a shape ``kernel_for`` sends to
    ``mma_sync`` (and so is an unknown name), before any device is
    touched; ``mma_sync`` takes the shape."""
    assert MK.kernel_for(dtype, bt, d, F) == "mma_sync"
    p = MO.plan(torch.zeros(4, dtype=torch.int32), 2, bt)
    xs = torch.zeros((p.T_pad, d), dtype=dtype)
    dys = torch.zeros((p.T_pad, F), dtype=dtype)
    for bad in ("wgmma", "cublas"):
        with pytest.raises(ValueError, match="does not take"):
            MK.moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used, kernel=bad)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_gemm_dw_cuda(xs, dys, p.ends, bt, p.used, kernel="mma_sync")


@pytest.mark.parametrize("T,d,E,F,bt,kind", [
    (200, 32, 8, 48, 16, "empty_experts"),  # experts 1, 3, 5 and E - 1 empty
    (300, 24, 4, 100, 64, "random"),        # F ragged against 8 and 64
    (77, 40, 8, 96, 16, "one_expert"),
    (1000, 16, 6, 20, 64, "random")])
def test_backward_plain_versions_match_autograd_and_reference(T, d, E, F, bt,
                                                               kind):
    """dxs and dw of the plain backward equal autograd of the plain sorted
    forward, and, taken back through the plan, jax.vjp of the reference's
    oracle; NaN in xs and dys from ``used`` on changes nothing (no row
    there is read); the autograd Function's CPU path (``moe_gemm``) gives
    the reference's gradients and launches no kernel."""
    rng = np.random.default_rng(T + F)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, F)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((T, F)).astype(np.float32)
    eid = _ids(kind, T, E, seed=T)
    tx, te, tw, tdy = (torch.from_numpy(a) for a in (x, eid, w, dy))
    p = MO.plan(te, E, bt)
    xs, dys = MO.scatter_rows(tx, p), MO.scatter_rows(tdy, p)
    dx = moe_gemm_sorted_dx_reference(dys, p.block_expert, tw, bt, p.used)
    dw = moe_gemm_sorted_dw_reference(xs, dys, p.block_expert, E, bt, p.used)
    assert dx.shape == (p.T_pad, d) and dw.shape == (E, d, F)
    assert not dx[int(p.used):].any()
    counts = np.bincount(eid, minlength=E)
    assert not dw[torch.from_numpy(counts == 0)].any()

    xl, wl = xs.clone().requires_grad_(), tw.clone().requires_grad_()
    ys = moe_gemm_sorted_reference(xl, p.block_expert, wl, bt, p.used)
    gx, gw = torch.autograd.grad(ys, (xl, wl), dys)
    torch.testing.assert_close(dx, gx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, gw, atol=1e-5, rtol=1e-5)

    _, vjp = jax.vjp(lambda a, b: jax_reference(a, jnp.asarray(eid), b),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    tol = lambda a: 1e-5 * np.abs(a).max()
    assert np.abs(MO.gather_rows(dx, p).numpy() - jdx).max() <= tol(jdx)
    assert np.abs(dw.numpy() - jdw).max() <= tol(jdw)

    n = int(p.used)
    if n < p.T_pad:
        xn, dyn = xs.clone(), dys.clone()
        xn[n:], dyn[n:] = float("nan"), float("nan")
        assert torch.equal(moe_gemm_sorted_dx_reference(
            dyn, p.block_expert, tw, bt, p.used), dx)
        assert torch.equal(moe_gemm_sorted_dw_reference(
            xn, dyn, p.block_expert, E, bt, p.used), dw)

    before = (MO.launches, MO.bwd_launches)
    xl, wl = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    gx, gw = torch.autograd.grad(MO.moe_gemm(xl, te, wl, block_t=bt),
                                 (xl, wl), tdy)
    assert (MO.launches, MO.bwd_launches) == before
    assert np.abs(gx.numpy() - jdx).max() <= tol(jdx)
    assert np.abs(gw.numpy() - jdw).max() <= tol(jdw)


def test_scatter_rows_backward_sums_a_tokens_assignments():
    """``scatter_rows(x, p, top_k)``'s gradient of x is each token's top_k
    assignment rows summed, and its forward is the token of assignment a at
    row slot_of[a]."""
    rng = np.random.default_rng(5)
    K, T, d, E = 3, 11, 4, 5
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    eid = torch.from_numpy(_ids("random", T * K, E, seed=5))
    p = MO.plan(eid, E, 16)
    xl = x.clone().requires_grad_()
    xs = MO.scatter_rows(xl, p, K)
    a = torch.arange(T * K)
    slot_of = MO.gather_rows(torch.arange(p.T_pad)[:, None], p)[:, 0]
    assert torch.equal(xs[slot_of], x[a // K])
    assert not xs[torch.isin(torch.arange(p.T_pad), slot_of,
                             invert=True)].any()
    g = torch.from_numpy(rng.standard_normal((p.T_pad, d)).astype(np.float32))
    gx, = torch.autograd.grad(xs, xl, g)
    torch.testing.assert_close(gx, g[slot_of].reshape(T, K, d).sum(1))


@pytest.mark.parametrize("top_k", [1, 6, 8])
@pytest.mark.parametrize("bt", [16, 64, 128])
@pytest.mark.parametrize("T", [37, 200])
def test_plain_dispatch_equals_scatter_rows(top_k, bt, T):
    """The row dispatch's plain version is ``scatter_rows``' buffer: every
    row below ``used`` bit for bit (a group's padding rows 0), and 0 from
    ``used`` on; a T whose assignments fill no block (37 tokens) leaves
    padding in every used group. No kernel is launched, and ``rows_take``
    sends no CPU tensor to the row kernels."""
    from repro_torch.kernels.moe_gemm.ref import dispatch_rows_reference
    E, d = 16, 24
    rng = np.random.default_rng(T * top_k + bt)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)
                         ).to(torch.bfloat16)
    ids = torch.from_numpy(np.argsort(rng.random((T, E)), 1)[:, :top_k]
                           .reshape(-1))
    p = MO.plan(ids, E, bt)
    n = int(p.used)
    want = MO.scatter_rows(x, p, top_k)
    before = (MO.launches, MO.row_launches)
    got = MO.dispatch_rows(x, p, top_k)
    assert (MO.launches, MO.row_launches) == before
    assert torch.equal(got, want)
    assert torch.equal(dispatch_rows_reference(x, p.slot_of, p.T_pad, top_k),
                       want)
    assert not got[n:].any()
    real = torch.zeros(p.T_pad, dtype=torch.bool)
    real[p.slot_of.long()] = True
    assert int(real.sum()) == T * top_k and not real[n:].any()
    assert not got[:n][~real[:n]].any()  # the padding rows
    padded = (p.counts.long() + bt - 1) // bt * bt
    assert n - T * top_k == int((padded - p.counts).sum()) > 0
    assert not MO.rows_take(x)


def test_plan_slot_of_is_the_inverse_of_the_sort():
    """``plan``'s ``slot_of`` is the buffer row of each assignment (the
    inverse of ``order`` and ``slot``) and ``counts`` each expert's real
    rows, both int32; ``gather_rows`` reads through it."""
    rng = np.random.default_rng(9)
    eid = torch.from_numpy(_ids("empty_experts", 300, 8, seed=9))
    p = MO.plan(eid, 8, 16)
    assert p.slot_of.dtype == torch.int32 and p.counts.dtype == torch.int32
    assert torch.equal(p.slot_of[p.order], p.slot)
    assert torch.equal(p.counts.long(), torch.bincount(eid.long(),
                                                       minlength=8))
    ys = torch.from_numpy(rng.standard_normal((p.T_pad, 5)).astype(
        np.float32))
    assert torch.equal(MO.gather_rows(ys, p), ys[p.slot_of.long()])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,K,E,bt", [(37, 6, 64, 16), (300, 6, 8, 64),
                                      (100, 8, 16, 16), (50, 1, 4, 16)])
def test_plain_combine_is_the_gather_and_batched_product(dtype, T, K, E, bt):
    """The row combine's plain version is, bit for bit, the dropless MoE
    layer's torch steps: ``gather_rows`` of the sorted rows, then
    ``torch.bmm`` of the weights rounded to the rows' dtype; no kernel is
    launched."""
    from repro_torch.kernels.moe_gemm.ref import combine_rows_reference
    d = 40
    rng = np.random.default_rng(T + K)
    ids = torch.from_numpy(np.argsort(rng.random((T, E)), 1)[:, :K]
                           .reshape(-1))
    p = MO.plan(ids, E, bt)
    ys = torch.from_numpy(rng.standard_normal((p.T_pad, d)).astype(
        np.float32)).to(dtype)
    ys[int(p.used):] = float("nan")   # rows from used on are never read
    w = torch.from_numpy((rng.random((T, K)) * 2.446).astype(np.float32))
    want = torch.bmm(w.to(dtype)[:, None, :],
                     MO.gather_rows(ys, p).view(T, K, d))[:, 0]
    before = (MO.launches, MO.row_launches)
    got = MO.combine_rows(ys, p, w)
    assert (MO.launches, MO.row_launches) == before
    assert got.dtype == dtype and got.shape == (T, d)
    assert torch.equal(got, want)
    assert torch.equal(combine_rows_reference(ys, p.slot_of, w), want)
    assert torch.isfinite(got).all()
    assert not MO.rows_take(ys, w)


def test_row_kernel_wrappers_refuse_cpu_tensors():
    p = MO.plan(torch.zeros(8, dtype=torch.int32), 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_dispatch_rows_cuda(torch.zeros((4, 8)), p.slot_of, p.counts,
                                  p.ends, p.T_pad, 2)
    with pytest.raises(ValueError, match="CUDA"):
        MK.moe_combine_rows_cuda(torch.zeros((p.T_pad, 8)), p.slot_of,
                                 torch.zeros((4, 2)))


def test_row_kernel_names_leave_the_gemm_class():
    """No ``__global__`` function of ``moe_rows.cu`` has ``gemm`` in its
    name: the benchmark's yardstick files a kernel named with ``gemm`` as a
    GEMM, and the grouped GEMMs' roofline reads kernels named
    ``moe_gemm``."""
    import re
    from pathlib import Path
    src = (Path(MK.__file__).parent / "csrc" / "moe_rows.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert sorted(names) == ["moe_combine_rows", "moe_dispatch_rows"]
    assert not [n for n in names if "gemm" in n.lower()]
