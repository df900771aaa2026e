"""Plain versions of the KDA recurrence (Kimi Delta Attention: a gated
delta rule with a per-channel decay), in float32.

Layouts: q, k (B, S, H, dk); v (B, S, H, dv); g (B, S, H, dk) the
log-decay (<= 0); beta (B, S, H); a state (B, H, dk, dv). With S_0 the
initial state (zeros by default), token t takes

    S_t = Diag(exp g_t) S_{t-1}
    S_t += beta_t k_t (v_t - S_t^T k_t)^T
    o_t = S_t^T (scale * q_t)

``kda_recurrent`` is that definition, token by token. ``kda_chunked`` is
the kernel's arithmetic (``csrc/kda_fwd.cu``): chunks of ``CHUNK`` tokens
in the WY/UT form. In a chunk, Gamma is the cumulative sum of g and

    A_ij   = beta_i sum_c k_ic k_jc exp(Gamma_ic - Gamma_jc),  j < i
    Aqk_ij = scale sum_c q_ic k_jc exp(Gamma_ic - Gamma_jc),   j <= i
    T = (I + A)^-1,  T' = T Diag(beta)
    w = T' (k exp Gamma),  u = T' v
    v' = u - w S,  o = (scale q exp Gamma) S + Aqk v'
    S <- Diag(exp Gamma_C) S + (k exp(Gamma_C - Gamma))^T v'

Every exponent is <= 0 (g <= 0, so Gamma falls along the chunk): A's and
Aqk's 16 x 16 sub-blocks off the diagonal factor through the later
sub-block's first row r, exp(Gamma_i - Gamma_r) exp(Gamma_r - Gamma_j);
the diagonal sub-blocks are computed pair by pair; exp(-Gamma) alone is
never formed. ``k exp(Gamma_C - Gamma)`` is rounded to k's dtype, as the
kernel keeps it in shared memory. With ``tf32`` every operand of the
chunk's products (A's and Aqk's off-diagonal blocks, w, u, v', o and the
state update) is rounded to TF32 first, to nearest with ties away from
zero, as the kernel's tensor-core products take them (``cvt.rna``); the
diagonal blocks and T stay in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

CHUNK = 64   # tokens a chunk
SUB = 16     # rows a sub-block of A and Aqk


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero, kept in float32."""
    xi = x.float().contiguous().view(torch.int32)
    return ((xi + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return round_tf32(a) @ round_tf32(b) if tf32 else a @ b


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, ...) -> (B, H, S, ...) float32."""
    return x.float().transpose(1, 2)


def kda_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, beta: torch.Tensor, *, scale: float,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence token by token -> (o (B, S, H, dv) float32, the final
    state (B, H, dk, dv) float32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    st = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
          if initial_state is None else initial_state.float().clone())
    qf, kf, vf, gf = (_heads_first(x) for x in (q, k, v, g))
    bf = beta.float().transpose(1, 2)                       # (B, H, S)
    o = torch.empty((B, H, S, dv), dtype=torch.float32, device=q.device)
    for t in range(S):
        st = st * torch.exp(gf[:, :, t])[..., None]
        kt = kf[:, :, t]
        pred = torch.einsum("bhk,bhkv->bhv", kt, st)
        st = st + torch.einsum("bhk,bhv->bhkv", bf[:, :, t, None] * kt,
                               vf[:, :, t] - pred)
        o[:, :, t] = torch.einsum("bhk,bhkv->bhv", scale * qf[:, :, t], st)
    return o.transpose(1, 2), st


def intra_chunk(q: torch.Tensor, k: torch.Tensor, G: torch.Tensor,
                scale: float, tf32: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_c k_ic k_jc e^(G_ic - G_jc) for j < i, scale sum_c q_ic k_jc
    e^(G_ic - G_jc) for j <= i) of one chunk, (..., C, C) each; q, k, G
    (..., C, dk), G non-increasing along C."""
    C = k.shape[-2]
    A = k.new_zeros(k.shape[:-2] + (C, C))
    Aqk = torch.zeros_like(A)
    tri = torch.ones(SUB, SUB, dtype=torch.bool, device=k.device).tril()
    for r in range(0, C, SUB):
        rows = slice(r, r + SUB)
        d = G[..., rows, None, :] - G[..., None, rows, :]   # (.., i, j, c)
        e = torch.exp(torch.where(tri[:, :, None], d, torch.zeros_like(d)))
        kj = k[..., None, rows, :] * e
        strict = tri.logical_and(~torch.eye(SUB, dtype=torch.bool,
                                            device=k.device))
        A[..., rows, rows] = torch.einsum("...ic,...ijc->...ij",
                                          k[..., rows, :], kj) * strict
        Aqk[..., rows, rows] = scale * torch.einsum(
            "...ic,...ijc->...ij", q[..., rows, :], kj) * tri
        if r:
            left = torch.exp(G[..., rows, :] - G[..., r:r + 1, :])
            right = (k[..., :r, :] * torch.exp(G[..., r:r + 1, :]
                                               - G[..., :r, :])
                     ).transpose(-1, -2)
            A[..., rows, :r] = _mm(k[..., rows, :] * left, right, tf32)
            Aqk[..., rows, :r] = scale * _mm(q[..., rows, :] * left, right,
                                             tf32)
    return A, Aqk


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor, *, scale: float,
                initial_state: Optional[torch.Tensor] = None,
                chunk: int = CHUNK, tf32: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form -> (o (B, S, H, dv) in q's dtype, the final state
    (B, H, dk, dv) float32). A last chunk shorter than ``chunk`` is padded
    with tokens of q = k = v = 0, g = 0, beta = 0, which change nothing.
    ``tf32``: the products' operands rounded as the kernel's are."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    dt = k.dtype
    pad = (-S) % chunk
    qf, kf, vf, gf = (_heads_first(x) for x in (q, k, v, g))
    bf = beta.float().transpose(1, 2)
    if pad:
        qf, kf, vf, gf = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                          for x in (qf, kf, vf, gf))
        bf = torch.nn.functional.pad(bf, (0, pad))
    st = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
          if initial_state is None else initial_state.float().clone())
    eye = torch.eye(chunk, dtype=torch.float32, device=q.device)
    o = torch.empty((B, H, S + pad, dv), dtype=torch.float32,
                    device=q.device)
    for c0 in range(0, S + pad, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, bc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            bf[:, :, sl]
        G = torch.cumsum(gf[:, :, sl], dim=2)
        A, Aqk = intra_chunk(qc, kc, G, scale, tf32)
        T = torch.linalg.solve_triangular(eye + A * bc[..., None], eye,
                                          upper=False, unitriangular=True)
        Tb = T * bc[..., None, :]
        w = _mm(Tb, kc * torch.exp(G), tf32)
        vnew = _mm(Tb, vc, tf32) - _mm(w, st, tf32)
        o[:, :, sl] = _mm(scale * qc * torch.exp(G), st, tf32) \
            + _mm(Aqk, vnew, tf32)
        GC = G[:, :, -1:]
        kt = (kc * torch.exp(GC - G)).to(dt).float()
        st = st * torch.exp(GC).transpose(-1, -2) \
            + _mm(kt.transpose(-1, -2), vnew, tf32)
    return o[:, :, :S].transpose(1, 2).to(q.dtype), st
