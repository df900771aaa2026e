"""Plain reference of Kimi-Linear-48B-A3B
(hf:moonshotai/Kimi-Linear-48B-A3B-Instruct, ``model_type`` kimi_linear),
float32, every product through ``precision.matmul`` (``run`` turns TF32
off on the card), written from the published config and Moonshot AI's
report "Kimi Linear: An Expressive, Efficient Attention Architecture"
(2025), in the port's parameter layout:

* KDA layers (``linear_attn_config.kda_layers``, 1-indexed): q, k, v =
  x W_q, x W_k, x W_v, each through a causal depthwise convolution
  ``short_conv_kernel_size`` wide (zeros before the first token) and a
  SiLU; q and k L2-normed per head (eps 1e-6 inside the root); beta =
  sigmoid(x W_b); g = -exp(A_log[h]) softplus(x W_fa W_fb + dt_bias);
  then, token by token, with the state S (dk, dv) a head starting at 0:
  S = Diag(exp g_t) S, S += beta_t k_t (v_t - S^T k_t)^T, o_t = S^T q_t /
  sqrt(dk); o RMS-normed per head (``kda_norm_eps``) times sigmoid(x W_ga
  W_gb + b_g), then W_o. This is the recurrence by its definition, not a
  chunked form;
* MLA layers (``full_attn_layers``) without RoPE (``mla_use_nope``): q = x
  W_q (H, nope + rope); [c_kv | k_pe] = x W_kv_a, c_kv RMS-normed
  (``latent_norm_eps``); [k_nope | v] = c_kv W_kv_b; k = [k_nope | k_pe]
  with the one k_pe head shared, no rotation anywhere; causal softmax at
  1/sqrt(nope + rope); o W_o;
* the first ``first_k_dense_replace`` layers a dense SwiGLU
  (``intermediate_size``), the rest MoE: sigmoid router, the top
  ``num_experts_per_token`` of scores + ``e_score_correction_bias`` (one
  group), weights renormalised (``moe_renormalize``) and times
  ``routed_scaling_factor``, every routed token kept, plus
  ``num_shared_experts`` shared experts (``moonlight``'s MoE layer);
* RMSNorm (``rms_norm_eps``) before each half and at the end, an untied
  LM head.

Departures from the published model, none of which changes a width: the
weights are random (the benchmark draws them from ``--seed``); RECALL's
exit head is added (after every ``exit_interval`` layers and the last
one run, the prompt's mean hidden state through the shared exit head), as
the port serves it; ``stage_layers``, where the configuration gives it,
runs the first that many layers (a pipeline's first stage). ``c`` is the
configuration file's dict (its HF key names). Imports nothing of the
program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from bench.reference import layers as RL
from bench.reference import moonlight as RM
from bench.reference.imagebind import exit_layers as every_k
from bench.reference.precision import matmul


def n_layers(c: Dict) -> int:
    """The layers run: ``stage_layers`` where given, else all."""
    return c.get("stage_layers", c["num_hidden_layers"])


def kda_layers(c: Dict) -> tuple:
    """The 0-indexed KDA layers among those run."""
    return tuple(i - 1 for i in c["linear_attn_config"]["kda_layers"]
                 if i <= n_layers(c))


def exit_layers(c: Dict) -> tuple:
    """1-indexed exit depths: every ``exit_interval`` layers and the last
    run."""
    return every_k(n_layers(c), c["exit_interval"])


def _moe_keys(c: Dict) -> Dict:
    """The MoE keys under the names ``moonlight.moe`` reads."""
    return {"n_routed_experts": c["num_experts"],
            "num_experts_per_tok": c["num_experts_per_token"],
            "norm_topk_prob": c["moe_renormalize"],
            "routed_scaling_factor": c["routed_scaling_factor"]}


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of x (B, S, C) with w (K,
    C): y_t = sum_j w[j] x_{t - K + 1 + j}, zeros before the first
    token."""
    K, S = w.shape[0], x.shape[1]
    y = torch.zeros_like(x)
    for j in range(K):
        shift = K - 1 - j
        if shift < S:
            y[:, shift:] += w[j].float() * x[:, :S - shift]
    return F.silu(y)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor, prec: str):
    """The gated delta rule token by token: q (scaled), k, v (B, S, H, d),
    g (B, S, H, dk), beta (B, S, H) -> (o (B, S, H, dv), the final state
    (B, H, dk, dv)). At ``fp32`` each token's products are plain batched
    float32 products (the rank-one update added in place); at a lower
    precision every product goes through ``precision.matmul``."""
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    st = torch.zeros((B * H, dk, dv), dtype=torch.float32, device=k.device)
    decay = torch.exp(g).transpose(1, 2).reshape(B * H, S, dk, 1)
    kh = k.transpose(1, 2).reshape(B * H, S, 1, dk)
    bkh = (beta[..., None] * k).transpose(1, 2).reshape(B * H, S, dk, 1)
    vh = v.transpose(1, 2).reshape(B * H, S, 1, dv)
    qh = q.transpose(1, 2).reshape(B * H, S, 1, dk)
    o = []
    for t in range(S):
        st.mul_(decay[:, t])
        d = vh[:, t] - matmul(kh[:, t], st, prec)         # (B H, 1, dv)
        if prec == "fp32":
            st.baddbmm_(bkh[:, t], d)
        else:
            st += matmul(bkh[:, t], d, prec)
        o.append(matmul(qh[:, t], st, prec))
    o = torch.cat(o, dim=1).view(B, H, S, dv).transpose(1, 2)
    return o, st.view(B, H, dk, dv)


def kda(kp: Dict, j: int, h: torch.Tensor, c: Dict, prec: str,
        on_state: Optional[Callable] = None) -> torch.Tensor:
    """KDA layer ``j`` (its position among the KDA layers) on the normed h
    (B, S, d) -> (B, S, d); ``on_state(j, state)`` gets the layer's final
    state (B, H, dk, dv)."""
    B, S, d = h.shape
    la = c["linear_attn_config"]
    H, hd, r = la["num_heads"], la["head_dim"], c["kda_gate_rank"]
    x2 = h.reshape(B * S, d)

    def proj(w, x):
        return matmul(x, w.reshape(w.shape[0], -1), prec)

    qkv = []
    for w, cw in (("wq", "conv_q"), ("wk", "conv_k"), ("wv", "conv_v")):
        pre = proj(kp[w][j], x2).reshape(B, S, H * hd)
        qkv.append(causal_conv(pre, kp[cw][j].reshape(-1, H * hd)).reshape(
            B, S, H, hd))
    q, k, v = qkv
    q, k = l2norm(q) / math.sqrt(hd), l2norm(k)
    f = proj(kp["w_fb"][j], proj(kp["w_fa"][j], x2)).reshape(B, S, H, hd)
    g = -torch.exp(kp["a_log"][j].float())[:, None] * F.softplus(
        f + kp["dt_bias"][j].float())
    beta = torch.sigmoid(proj(kp["w_b"][j], x2)).reshape(B, S, H)
    o, st = recurrence(q, k, v, g, beta, prec)
    if on_state is not None:
        on_state(j, st)
    gate = proj(kp["w_gb"][j], proj(kp["w_ga"][j], x2)).reshape(B, S, H, hd)
    o = RL.rmsnorm(o, kp["o_norm"][j], c["kda_norm_eps"]) * torch.sigmoid(
        gate + kp["b_g"][j].float())
    return proj(kp["wo"][j].reshape(H * hd, d), o.reshape(B * S, H * hd)
                ).reshape(B, S, d)


def mla(at: Dict, j: int, h: torch.Tensor, c: Dict, prec: str,
        on_latent: Optional[Callable] = None) -> torch.Tensor:
    """MLA layer ``j`` (its position among the MLA layers) without RoPE on
    the normed h (B, S, d) -> (B, S, d); ``on_latent(j, c_kv, k_pe)`` gets
    its (B, S, r) and (B, S, rope) latent rows."""
    B, S, d = h.shape
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    h2 = h.reshape(B * S, d)
    q = matmul(h2, at["wq"][j].reshape(d, -1), prec).reshape(B, S, H, -1)
    ckv = matmul(h2, at["w_kv_a"][j], prec).reshape(B, S, r + rp)
    ckv_n = RL.rmsnorm(ckv[..., :r], at["kv_norm"][j], c["latent_norm_eps"])
    k_pe = ckv[..., r:]
    if on_latent is not None:
        on_latent(j, ckv_n, k_pe)
    kv = matmul(ckv_n.reshape(B * S, r), at["w_kv_b"][j].reshape(r, -1),
                prec).reshape(B, S, H, -1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(B, S, H, rp)], -1)
    o = RM.attention(q, k, kv[..., nope:], scale=1.0 / math.sqrt(nope + rp),
                     prec=prec)
    wo = at["wo"][j]
    return matmul(o.reshape(B * S, -1), wo.reshape(-1, d), prec).reshape(
        B, S, d)


def layer(lp: Dict, i: int, x: torch.Tensor, c: Dict, prec: str,
          on_latent: Optional[Callable] = None,
          on_state: Optional[Callable] = None) -> torch.Tensor:
    B, S, d = x.shape
    eps = c["rms_norm_eps"]
    kl = kda_layers(c)
    h = RL.rmsnorm(x, lp["norm1"][i], eps)
    n_kda = sum(1 for j in kl if j < i)
    if i in kl:
        x = x + kda(lp["kda"], n_kda, h, c, prec, on_state)
    else:
        x = x + mla(lp["attn"], i - n_kda, h, c, prec, on_latent)
    h = RL.rmsnorm(x, lp["norm2"][i], eps).reshape(B * S, d)
    k = c["first_k_dense_replace"]
    y = (RM.swiglu(lp["mlp"], i, h, prec) if i < k
         else RM.moe(lp["moe"], i - k, h, _moe_keys(c), prec))
    return x + y.reshape(B, S, d)


def run(params: Dict, tokens: torch.Tensor, c: Dict, prec: str = "fp32",
        on_latent: Optional[Callable] = None,
        on_state: Optional[Callable] = None,
        exits: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The prompt ``tokens`` (B, S) through every layer run: {"h": the final
    hidden state (B, S, d), "exit_embs": (n_exits, B, E) at ``exits``
    (1-indexed; empty: none)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = params["embed"]
    x = table.float()[tokens.long().clamp(0, table.shape[0] - 1)]
    pooled = []
    for i in range(n_layers(c)):
        x = layer(params["layers"], i, x, c, prec, on_latent, on_state)
        if i + 1 in exits:
            pooled.append(x.mean(dim=1))
    out = {"h": x}
    if exits:
        out["exit_embs"] = RL.exit_embedding(
            params, torch.stack(pooled), c["rms_norm_eps"], prec)
    return out


def prefill(params: Dict, tokens: torch.Tensor, c: Dict, *,
            on_latent: Callable, on_state: Callable,
            prec: str = "fp32") -> torch.Tensor:
    """The prefill the port serves: ``on_latent(mla_layer, c_kv, k_pe)`` and
    ``on_state(kda_layer, state)`` as each layer's come; returns the exit
    embeddings (n_exits, B, E)."""
    return run(params, tokens, c, prec, on_latent, on_state,
               exit_layers(c))["exit_embs"]


def logits(params: Dict, tokens: torch.Tensor, c: Dict,
           prec: str = "fp32") -> torch.Tensor:
    """(B, S, V) next-token logits of the full forward pass."""
    h = run(params, tokens, c, prec)["h"]
    h = RL.rmsnorm(h, params["final_norm"], c["rms_norm_eps"])
    B, S, d = h.shape
    return matmul(h.reshape(B * S, d), params["lm_head"], prec).reshape(
        B, S, -1)
