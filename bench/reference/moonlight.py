"""Plain reference of Moonlight-16B-A3B (hf:moonshotai/Moonlight-16B-A3B,
``model_type`` deepseek_v3): DeepSeek-V3's decoder block at the
configuration's widths, float32, every product through
``precision.matmul`` (TF32 off on the card), written from the published
config and modeling file, in the port's parameter layout:

* attention (MLA, ``q_lora_rank`` null): q = x W_q (H, nope + rope);
  [c_kv | k_pe] = x W_kv_a, c_kv RMS-normed with eps 1e-6 (the modeling
  file's default for ``kv_a_layernorm``); [k_nope | v] = c_kv W_kv_b (H,
  nope + v); RoPE on q's rope part and the one shared k_pe head; causal
  softmax at 1/sqrt(nope + rope) (``rope_scaling`` null: no mscale);
  o W_o;
* RoPE as the modeling file applies it: the rope dims taken as
  interleaved pairs, de-interleaved (evens, then odds), rotated
  rotate-half; the latent cache holds that layout of k_pe;
* the first ``first_k_dense_replace`` layers a dense SwiGLU
  (``intermediate_size``), the rest MoE: sigmoid(x W_r) scores, the top
  ``num_experts_per_tok`` of scores + ``e_score_correction_bias`` (one
  group), weights the unbiased scores renormalised and times
  ``routed_scaling_factor``, every routed token kept, each expert a
  SwiGLU (``moe_intermediate_size``), plus ``n_shared_experts`` shared
  experts as one SwiGLU;
* RMSNorm (``rms_norm_eps``) before each half and at the end, an untied
  LM head.

Departures from the published model, none of which changes a width: the
weights are random (the benchmark draws them from ``--seed``); RECALL's
exit head is added (after every ``exit_interval`` layers and the last,
the prompt's mean hidden state through the shared exit head), as the
port serves it; the latent cache is the serving layout of vLLM and
SGLang (c_kv after its norm, k_pe after RoPE), where the modeling file
caches full keys and values. ``c`` is the configuration file's dict (its
HF key names); the layer weights are stacked, ``layers.mlp`` over the
dense layers and ``layers.moe`` over the MoE layers. Imports nothing of
the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

from bench.reference import layers as RL
from bench.reference.imagebind import exit_layers as every_k
from bench.reference.precision import matmul

Q_BLOCK = 1024      # query rows a block of the attention
LATENT_EPS = 1e-6   # kv_a_layernorm's eps in the modeling file


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, rope) at positions 0..S-1: de-interleave, then
    rotate-half (DeepSeek-V3's ``apply_rotary_pos_emb``)."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return RL.rope(x, theta)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, prec: str) -> torch.Tensor:
    """Causal softmax(q k^T scale) v, q/k (B, S, H, Dqk), v (B, S, H, Dv)
    -> (B, S, H, Dv) float32; query rows in blocks of ``Q_BLOCK``, a block
    reading the keys up to its last row."""
    B, S, H, _ = q.shape
    out = torch.empty((B, S, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for b in range(B):
        kt = k[b].permute(1, 2, 0)                    # (H, Dqk, S)
        vt = v[b].permute(1, 0, 2)                    # (H, S, Dv)
        for i0 in range(0, S, Q_BLOCK):
            i1 = min(i0 + Q_BLOCK, S)
            qb = q[b, i0:i1].permute(1, 0, 2)         # (H, rows, Dqk)
            s = matmul(qb, kt[:, :, :i1], prec) * scale
            rows = torch.arange(i0, i1, device=q.device)[:, None]
            cols = torch.arange(i1, device=q.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
            o = matmul(torch.softmax(s, dim=-1), vt[:, :i1], prec)
            out[b, i0:i1] = o.permute(1, 0, 2)
    return out


def mla(at: Dict, i: int, h: torch.Tensor, c: Dict, prec: str,
        on_latent: Optional[Callable] = None) -> torch.Tensor:
    """Layer ``i``'s attention on the normed h (B, S, d) -> (B, S, d);
    ``on_latent(i, c_kv, k_pe)`` gets the layer's (B, S, r) and (B, S,
    rope) latent rows."""
    B, S, d = h.shape
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    nope, rp = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    h2 = h.reshape(B * S, d)
    q = matmul(h2, at["wq"][i].reshape(d, -1), prec).reshape(B, S, H, -1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], c["rope_theta"])], -1)
    ckv = matmul(h2, at["w_kv_a"][i], prec).reshape(B, S, r + rp)
    ckv_n = RL.rmsnorm(ckv[..., :r], at["kv_norm"][i], LATENT_EPS)
    k_pe = rope(ckv[..., r:][:, :, None], c["rope_theta"])[:, :, 0]
    if on_latent is not None:
        on_latent(i, ckv_n, k_pe)
    kv = matmul(ckv_n.reshape(B * S, r), at["w_kv_b"][i].reshape(r, -1),
                prec).reshape(B, S, H, -1)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(B, S, H, rp)], -1)
    o = attention(q, k, kv[..., nope:], scale=1.0 / math.sqrt(nope + rp),
                  prec=prec)
    wo = at["wo"][i]
    return matmul(o.reshape(B * S, -1), wo.reshape(-1, d), prec).reshape(
        B, S, d)


def swiglu(mp: Dict, i: int, x: torch.Tensor, prec: str) -> torch.Tensor:
    g = matmul(x, mp["w_gate"][i], prec)
    u = matmul(x, mp["w_up"][i], prec)
    return matmul(torch.nn.functional.silu(g) * u, mp["w_down"][i], prec)


def route(mp: Dict, j: int, x: torch.Tensor, c: Dict, prec: str):
    """(top_i (T, K), weights (T, K)) of MoE layer ``j`` on x (T, d)."""
    scores = torch.sigmoid(matmul(x, mp["router"][j], prec))
    top_i = torch.topk(scores + mp["bias"][j].float(),
                       c["num_experts_per_tok"], dim=-1).indices
    w = torch.gather(scores, -1, top_i)
    if c["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return top_i, w * c["routed_scaling_factor"]


def moe(mp: Dict, j: int, x: torch.Tensor, c: Dict, prec: str
        ) -> torch.Tensor:
    """MoE layer ``j`` on x (T, d): every routed token through its experts
    (no capacity), one expert at a time, plus the shared experts."""
    top_i, w = route(mp, j, x, c, prec)
    y = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = matmul(xe, mp["w_gate"][j, e], prec)
        u = matmul(xe, mp["w_up"][j, e], prec)
        ye = matmul(torch.nn.functional.silu(g) * u, mp["w_down"][j, e],
                    prec)
        y.index_add_(0, tok, ye * w[tok, slot][:, None])
    if "shared" in mp:
        y = y + swiglu(mp["shared"], j, x, prec)
    return y


def layer(lp: Dict, i: int, x: torch.Tensor, c: Dict, prec: str,
          on_latent: Optional[Callable] = None) -> torch.Tensor:
    B, S, d = x.shape
    eps = c["rms_norm_eps"]
    x = x + mla(lp["attn"], i, RL.rmsnorm(x, lp["norm1"][i], eps), c, prec,
                on_latent)
    h = RL.rmsnorm(x, lp["norm2"][i], eps).reshape(B * S, d)
    k = c["first_k_dense_replace"]
    y = (swiglu(lp["mlp"], i, h, prec) if i < k
         else moe(lp["moe"], i - k, h, c, prec))
    return x + y.reshape(B, S, d)


def exit_layers(c: Dict) -> tuple:
    """1-indexed exit depths: every ``exit_interval`` layers and the
    last."""
    return every_k(c["num_hidden_layers"], c["exit_interval"])


def run(params: Dict, tokens: torch.Tensor, c: Dict, prec: str = "fp32",
        on_latent: Optional[Callable] = None,
        exits: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The prompt ``tokens`` (B, S) through every layer: {"h": the final
    hidden state (B, S, d), "exit_embs": (n_exits, B, E) at ``exits``
    (1-indexed; empty: none)}."""
    table = params["embed"]
    x = table.float()[tokens.long().clamp(0, table.shape[0] - 1)]
    pooled = []
    for i in range(c["num_hidden_layers"]):
        x = layer(params["layers"], i, x, c, prec, on_latent)
        if i + 1 in exits:
            pooled.append(x.mean(dim=1))
    out = {"h": x}
    if exits:
        out["exit_embs"] = RL.exit_embedding(
            params, torch.stack(pooled), c["rms_norm_eps"], prec)
    return out


def prefill(params: Dict, tokens: torch.Tensor, c: Dict, *,
            on_latent: Callable, prec: str = "fp32") -> torch.Tensor:
    """The prefill the port serves: ``on_latent(layer, c_kv, k_pe)`` as
    each layer's latent rows come; returns the exit embeddings (n_exits,
    B, E)."""
    return run(params, tokens, c, prec, on_latent, exit_layers(c))[
        "exit_embs"]


def logits(params: Dict, tokens: torch.Tensor, c: Dict,
           prec: str = "fp32") -> torch.Tensor:
    """(B, S, V) next-token logits of the full forward pass."""
    h = run(params, tokens, c, prec)["h"]
    h = RL.rmsnorm(h, params["final_norm"], c["rms_norm_eps"])
    B, S, d = h.shape
    return matmul(h.reshape(B * S, d), params["lm_head"], prec).reshape(
        B, S, -1)
