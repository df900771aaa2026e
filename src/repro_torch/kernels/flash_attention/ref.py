"""Plain PyTorch attention (materialised softmax) with the flash kernel's
masks and outputs.

q (B, Sq, H, D); k (B, Skv, KV, D), v (B, Skv, KV, Dv) with H % KV == 0
(GQA: head h reads kv head h // (H // KV)); the forward's output takes v's
head dim (MLA: q/k 192, v 128). ``q_offset`` shifts query positions
(query i sits at absolute position i + q_offset). Scores and softmax in
fp32.

``p_dtype`` gives the variant that rounds P as the TPU kernel does
(``p.astype(v.dtype)`` before P·V, ``repro/kernels/flash_attention/
kernel.py``): an online softmax over key blocks of ``block_kv`` (the whole
row when None), p = exp(s - m) in fp32 against the running row max m,
rounded to ``p_dtype``, (p · V) summed in fp32, l summed from the unrounded
p. A kernel with that rounding is held to this variant, per element, within
``bf16_step_limit``.

``attention_bwd_reference`` is the plain backward (the reference's
``_bwd_blocked``), the CPU path of the autograd function in ``ops.py`` and
the yardstick of the CUDA backward kernel (``bwd_limit``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: may query i (at position i + q_offset) see key j?"""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window and window > 0:
        mask &= kj > (qi - window)
    return mask


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            scale: Optional[float] = None,
                            p_dtype: Optional[torch.dtype] = None,
                            block_kv: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, H, Dv) in q's dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float()) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)                       # (B, KV, G, Sq)
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
    else:
        o = _pv_rounding_p(s, v.float(), p_dtype, block_kv or Skv)
    return (o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype),
            lse.reshape(B, H, Sq))


def _pv_rounding_p(s: torch.Tensor, v: torch.Tensor, p_dtype: torch.dtype,
                   block_kv: int) -> torch.Tensor:
    """softmax(s) V with p rounded to ``p_dtype`` against the running max
    over blocks of ``block_kv`` keys, as the TPU kernel's online softmax
    rounds it. s (B, KV, G, Sq, Skv) masked fp32 scores, v (B, Skv, KV, D)
    fp32 -> (B, Sq, KV, G, D)."""
    m = torch.full(s.shape[:-1], NEG_INF, device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + v.shape[-1:], device=s.device)
    for j0 in range(0, s.shape[-1], block_kv):
        sj = s[..., j0:j0 + block_kv]
        m_new = torch.maximum(m, sj.amax(-1))
        p = torch.exp(sj - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgqj,bjkd->bkgqd", p.to(p_dtype).float(),
                          v[:, j0:j0 + block_kv])
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4)


def bf16_step_limit(o_plain: torch.Tensor) -> torch.Tensor:
    """Per-element limit of a bf16 kernel output against the plain variant
    that rounds P as the kernel does: one bf16 step at max(|o_plain|, 1),
    i.e. 2^-7 below |o| = 2, 2^-6 in [2, 4), 2^-5 in [4, 8). Below |o| = 4
    that is no looser than an absolute 2e-2, and above it a flip of the
    final rounding at the element's own magnitude passes. It stays at 2^-7
    below |o| = 1: an element near 0 is a cancelled sum of terms the size
    of V, and another summation order moves it by more than its own bf16
    step."""
    mag = torch.clamp_min(o_plain.float().abs(), 1.0)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    return attention_fwd_reference(q, k, v, **kw)[0]


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0,
                            scale: Optional[float] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            grad_dtype: Optional[torch.dtype] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) in q's, k's, v's dtypes: the reference's recomputing
    backward ``_bwd_blocked`` (repro/kernels/flash_attention/ops.py),
    materialised. ``out``, ``lse`` are the forward's; ``do`` the cotangent
    of ``out``. delta = rowsum(dO * O), P = exp(S * scale - lse) and 0 where
    the mask hides a key (so a row that sees no key, which the forward
    gives a uniform softmax, passes no gradient), dV = P^T dO,
    dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q, products in
    fp32 with the reference's roundings in between: P to dO's dtype before
    dV, dS to k's (q's) dtype before dQ (dK), dO to v's dtype before
    dO V^T. ``compute_dtype=torch.float64`` runs the same arithmetic in
    float64 (the roundings kept): a yardstick of the fp32 versions' own
    error. ``grad_dtype`` gives the gradients another dtype than the
    inputs' (float64 keeps that yardstick unrounded)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    cd = compute_dtype
    low = lambda x, dt: x.to(dt).to(cd)  # a rounding to dt, kept in cd
    qg = q.reshape(B, Sq, KV, G, D).to(cd)
    dog = do.reshape(B, Sq, KV, G, D)
    kf, vf = k.to(cd), v.to(cd)
    delta = (dog.to(cd) * out.reshape(B, Sq, KV, G, D).to(cd)).sum(-1)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kf) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, Sq)[..., None]
                                    .to(cd)), torch.zeros_like(s))
    dp = torch.einsum("bqkgd,bjkd->bkgqj", low(dog, v.dtype), vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dq = torch.einsum("bkgqj,bjkd->bqkgd", low(ds, k.dtype), kf)
    dk = torch.einsum("bkgqj,bqkgd->bjkd", low(ds, q.dtype), qg)
    dv = torch.einsum("bkgqj,bqkgd->bjkd", low(p, do.dtype),
                      low(dog, do.dtype))
    return (dq.reshape(B, Sq, H, D).to(grad_dtype or q.dtype),
            dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype))


# how far a backward kernel's bwd_rel_err may sit above the plain
# version's in the same dtype
REL_MULTIPLE = 4.0


def bwd_rel_err(g: torch.Tensor, g64: torch.Tensor) -> float:
    """max over the elements of |g - g64| / (|g64| + m), m the median |g64|
    of the nonzero elements: a gradient's error relative to each element
    of the float64 backward ``g64`` (``attention_bwd_reference`` with
    ``compute_dtype=grad_dtype=torch.float64``), with a floor of the
    tensor's typical element under the ones near 0. Where g64 is 0 (a row
    that sees no key) g must be 0. A kernel is held to ``REL_MULTIPLE``
    times the plain version's value, which ``bwd_limit`` cannot do below
    |g| = 1."""
    a = g64.double().abs()
    nz = a[a > 0]
    m = nz.median().item() if nz.numel() else 0.0
    err = (g.double() - g64.double()).abs()
    return torch.where(err == 0, torch.zeros_like(err),
                       err / (a + m)).max().item()


def bwd_limit(g_plain: torch.Tensor) -> torch.Tensor:
    """Per-element limit of a backward kernel's gradient against the plain
    version: 1e-5 relative at max(|g|, 1) in f32 (the fp32 sums run in
    another order), one bf16 step at max(|g|, 1) in bf16
    (``bf16_step_limit``: the final rounding, or a rounding of P or dS, may
    flip)."""
    if g_plain.dtype == torch.float32:
        return 1e-5 * torch.clamp_min(g_plain.abs(), 1.0)
    return bf16_step_limit(g_plain)
