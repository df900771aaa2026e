"""Transformer stack (decoder LM / bidirectional encoder) with Recall exits.

Layer parameters are *stacked* (leading ``n_layers`` dim, the reference's
layout); ``forward_hidden`` runs layers ``[layer_start, layer_end)`` as a
Python loop over that dim, which is how coarse (early-exited) encoding and
live-encoder refinement (paper §3.4) reuse one weight set. The LM serving
path is ``prefill`` (a prompt batch into a preallocated, padded KV cache,
with the exit embeddings) and ``decode_step`` (one greedy token against
that cache, written in place).

Attention goes through the flash kernel's dispatch at prefill and the
decode kernel's at decode, the norms through the rmsnorm kernel's and MoE
layers through the grouped expert GEMM's (``models/moe.py``); the QKV, O,
SwiGLU, router and logits projections are plain ``torch.matmul``.

Training: ``lm_loss`` is the chunked cross-entropy (``chunked_xent``)
on the final norm's output through the LM head, plus the MoE layers' aux
loss; ``forward_hidden(remat=True)`` recomputes each layer in the
backward (``torch.utils.checkpoint``, the reference's per-layer
``jax.checkpoint`` that saves nothing), so a layer's flash and RMSNorm
forward kernels launch twice a step. The embedding table's gradient is
summed in float32 in a fixed order (``layers.embed_lookup``).

LoRA deltas (paper §3.3 P-LoRA) ride along as an optional stacked tree
(``core/plora.py``'s layout, sliced per layer like the params): on the
targets ``wq``/``wk``/``wv``/``wo``/``w_gate``/``w_up``/``w_down`` each
projection adds ``scale * ((x @ a) @ b)`` in x's dtype
(``layers.lora_delta``), where the reference adds it (the ``w_down`` delta,
in ``layers.swiglu``, reads the post-activation ``h``); the LoRA products
are plain ``torch.matmul`` too. ``lora=None`` or ``{}`` adds
nothing. Flash attention and RMSNorm are differentiable (their backward
kernels), so a loss on ``forward_hidden`` trains the LoRA on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LMConfig, RecallConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span


def lm_schema(cfg: LMConfig, recall: RecallConfig, *, embed_out: int = 1024,
              with_lm_head: bool = True) -> Schema:
    Ld = (cfg.n_layers,)
    layer: Schema = {
        "norm1": L.rmsnorm_schema(cfg.d_model, Ld),
        "norm2": L.rmsnorm_schema(cfg.d_model, Ld),
        "attn": L.attn_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qkv_bias, layer_dims=Ld),
    }
    if cfg.moe is not None:
        layer["moe"] = MOE.moe_schema(cfg.d_model, cfg.moe, layer_dims=Ld)
    else:
        layer["mlp"] = L.swiglu_schema(cfg.d_model, cfg.d_ff, layer_dims=Ld)
    s: Schema = {
        "embed": L.embed_schema(cfg.vocab, cfg.d_model),
        "layers": layer,
        "final_norm": L.rmsnorm_schema(cfg.d_model),
        # Recall exit head: shared across exits, left untuned during healing.
        "exit_head": {
            "norm": L.rmsnorm_schema(cfg.d_model),
            "proj": ParamDef((cfg.d_model, embed_out), ("embed", "act_embed"),
                             "fan_in"),
        },
    }
    if with_lm_head and not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                "fan_in")
    return s


def lm_init(gen: torch.Generator, cfg: LMConfig, recall: RecallConfig, *,
            device="cuda", **kw):
    """Random LM params from ``gen`` (a generator on ``device``), in the
    config's dtype."""
    return L.init_params(gen, lm_schema(cfg, recall, **kw),
                         dtype=L.torch_dtype(cfg.dtype), device=device)


def lm_specs(cfg: LMConfig, recall: RecallConfig, **kw):
    return L.param_specs(lm_schema(cfg, recall, **kw))


def lm_abstract(cfg: LMConfig, recall: RecallConfig, **kw):
    return L.abstract_params(lm_schema(cfg, recall, **kw), dtype=cfg.dtype)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked-layer param dict."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def _proj_qkv(p: Schema, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              rope_theta: float = 0.0, lora: Optional[Dict] = None,
              lora_scale: float = 0.0):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd), contiguous; RoPE at
    ``positions`` (B, S) when ``rope_theta`` > 0."""
    B, S, d = x.shape
    lora = lora or {}
    out = []
    for name, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        w = p[name].to(x.dtype)                          # (d, H, hd)
        y = (x.reshape(B * S, d) @ w.reshape(d, -1)).view(B, S, *w.shape[1:])
        if name in lora:
            y = y + L.lora_delta(x, lora[name], lora_scale)
        if bias in p:
            y = y + p[bias].to(x.dtype)
        out.append(y)
    q, k, v = out
    if rope_theta > 0:
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


def _attn_out(p: Schema, o: torch.Tensor, lora: Optional[Dict] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    B, S, H, hd = o.shape
    wo = p["wo"].to(o.dtype)                             # (H, hd, d)
    o2 = o.reshape(B * S, H * hd)
    y = (o2 @ wo.reshape(H * hd, -1)).view(B, S, -1)
    if lora and "wo" in lora:
        y = y + L.lora_delta(o2, lora["wo"], lora_scale).view(B, S, -1)
    return y


def _ffn(pl_: Schema, h: torch.Tensor, cfg: LMConfig,
         lora: Optional[Dict] = None, lora_scale: float = 0.0):
    """(y, aux): the MoE layer (aux its loss; LoRA has no MoE target) or
    the dense SwiGLU (aux None)."""
    if cfg.moe is not None:
        return MOE.moe_apply(pl_["moe"], h, cfg.moe)
    return L.swiglu(pl_["mlp"], h, lora, lora_scale), None


def layer_full(pl_: Schema, x: torch.Tensor, cfg: LMConfig,
               positions: Optional[torch.Tensor], *, window: int,
               lora: Optional[Dict] = None, lora_scale: float = 0.0):
    """Self-attention layer over the full (own) sequence -> (x, (k, v),
    aux or None). ``lora`` is this layer's slice."""
    with span("layer.attn"):
        h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
        q, k, v = _proj_qkv(pl_["attn"], h, positions, cfg.rope_theta, lora,
                            lora_scale)
        o = flash_attention(q, k, v, causal=cfg.causal, window=window)
        x = x + _attn_out(pl_["attn"], o, lora, lora_scale)
    with span("layer.mlp"):
        h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
        y, aux = _ffn(pl_, h2, cfg, lora, lora_scale)
        x = x + y
    return x, (k, v), aux


def layer_decode(pl_: Schema, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, cfg: LMConfig,
                 *, window: int, lora: Optional[Dict] = None,
                 lora_scale: float = 0.0):
    """One-token step. x (B,1,d); k/v_cache (B,S,KV,hd) of this layer;
    lengths (B,) int32 is the sequence length *including* the new token
    (the query sits at lengths-1). The new token's k/v are written into the
    caches in place at lengths-1, placed as the reference's
    ``dynamic_update_slice_in_dim`` places it: a negative index counts from
    the end, then the index is clamped to [0, S-1]. Returns (x, aux or
    None)."""
    B, S = k_cache.shape[:2]
    h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
    positions = (lengths - 1)[:, None]
    q, k_new, v_new = _proj_qkv(pl_["attn"], h, positions, cfg.rope_theta,
                                lora, lora_scale)
    rows = torch.arange(B, device=x.device)
    at = lengths.long() - 1
    at = torch.clamp(torch.where(at < 0, at + S, at), 0, S - 1)
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]
    o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                         window=window)
    x = x + _attn_out(pl_["attn"], o[:, None], lora, lora_scale)
    h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
    y, aux = _ffn(pl_, h2, cfg, lora, lora_scale)
    return x + y, aux


def forward_hidden(params: Schema, cfg: LMConfig, recall: RecallConfig, *,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   lora=None,
                   layer_start: int = 0, layer_end: Optional[int] = None,
                   collect_pooled: bool = False, pool: str = "mean",
                   return_kv: bool = False,
                   kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   remat: bool = False,
                   window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Run layers [layer_start, layer_end) on ``embeds`` (B, S, d) or on
    the embedding rows of ``tokens`` (B, S). Returns {"h": (B, S, d) final
    hidden, "aux": f32 scalar (the MoE layers' aux loss), "pooled":
    (L', B, d) per-layer pooled hidden (if collect_pooled; ``mask`` (B, S)
    makes the mean pool a masked mean), "kv": (k, v) caches of shape
    (L', B, S', KV, hd) (if return_kv)}. With ``kv_cache`` the layers' k/v
    are written into those caches at [i - layer_start, :, :S] (S' >= S; a
    prefill into a preallocated padded cache); without it caches of exactly
    S are allocated. ``lora`` (stacked over all n_layers) adds its deltas at
    scale ``recall.lora_alpha / recall.lora_rank``. ``remat`` keeps no
    layer's activations for the backward but its input, and runs the layer
    again there."""
    if pool not in ("cls", "mean"):
        raise ValueError(f"pool={pool!r}")
    if embeds is None:
        with span("lm.embed"):
            embeds = L.embed_lookup(params["embed"], tokens).to(
                L.torch_dtype(cfg.dtype))
    x = embeds
    B, S, _ = x.shape
    positions = None
    if cfg.rope_theta > 0:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    layer_end = cfg.n_layers if layer_end is None else layer_end
    window = cfg.window if window is None else window
    if return_kv and kv_cache is None:
        shape = (layer_end - layer_start, B, S, cfg.n_kv_heads, cfg.head_dim)
        kv_cache = (x.new_empty(shape), x.new_empty(shape))
    lora_scale = recall.lora_alpha / recall.lora_rank
    pooled, aux = [], None
    for i in range(layer_start, layer_end):
        run = lambda x_, p_, l_: layer_full(p_, x_, cfg, positions,
                                            window=window, lora=l_,
                                            lora_scale=lora_scale)
        p_i = layer_slice(params["layers"], i)
        l_i = layer_slice(lora, i) if lora else None
        if remat and torch.is_grad_enabled():
            x, (k, v), aux_l = torch.utils.checkpoint.checkpoint(
                run, x, p_i, l_i, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, (k, v), aux_l = run(x, p_i, l_i)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        if return_kv:
            with span("layer.kv_write"):
                kv_cache[0][i - layer_start, :, :S] = k
                kv_cache[1][i - layer_start, :, :S] = v
        if collect_pooled:
            with span("layer.pool"):
                if pool == "cls":
                    p = x[:, 0]
                elif mask is not None:
                    m = mask[..., None].float()
                    p = ((x.float() * m).sum(1)
                         / torch.clamp_min(m.sum(1), 1.0)).to(x.dtype)
                else:
                    p = x.float().mean(1).to(x.dtype)
            pooled.append(p)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = {"h": x, "aux": aux}
    if collect_pooled:
        out["pooled"] = torch.stack(pooled) if pooled else \
            x.new_zeros((0,) + x.shape[:1] + x.shape[2:])
    if return_kv:
        out["kv"] = kv_cache
    return out


def exit_embedding(params: Schema, pooled: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """pooled (..., d) -> L2-normalized embedding (..., E) via the shared
    exit head, in fp32."""
    with span("layer.exit_head"):
        h = L.rmsnorm(pooled, params["exit_head"]["norm"], eps)
        e = h.float() @ params["exit_head"]["proj"].float()
        return L.l2_normalize(e)


# ---------------------------------------------------------------------------
# LM exit API (paper §3.4): every exit at once, one exit, resume from a cache
# ---------------------------------------------------------------------------


def encode_exits(params: Schema, cfg: LMConfig, recall: RecallConfig,
                 tokens=None, embeds=None, mask=None, lora=None,
                 **fw_kw) -> Dict:
    """Embed at every exit granularity in one full-depth pass: {"exit_embs":
    (n_exits, B, E), "exits": the exit layers, "pooled": (L, B, d) every
    layer's pooled state, "h": (B, S, d), "aux"}. The exit head runs once
    over the stacked (n_exits * B, d) pooled rows."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, embeds=embeds,
                         mask=mask, lora=lora, collect_pooled=True, **fw_kw)
    exits = recall.exit_layers(cfg.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=out["h"].device)
    embs = exit_embedding(params, out["pooled"][idx], cfg.norm_eps)
    return {"exit_embs": embs, "exits": exits, "pooled": out["pooled"],
            "h": out["h"], "aux": out["aux"]}


def encode_at(params: Schema, cfg: LMConfig, recall: RecallConfig, e: int,
              tokens=None, embeds=None, mask=None, lora=None,
              **fw_kw) -> Dict:
    """The coarse embedding at exit depth ``e``, running only layers
    [0, e): {"emb": (B, E), "h": (B, S, d) the layer-e activations a store
    caches, "pooled_last": (B, d)}."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, embeds=embeds,
                         mask=mask, lora=lora, layer_end=e,
                         collect_pooled=True, **fw_kw)
    emb = exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
    return {"emb": emb, "h": out["h"], "pooled_last": out["pooled"][-1]}


def refine_from(params: Schema, cfg: LMConfig, recall: RecallConfig,
                h_cached: torch.Tensor, start: int, mask=None, lora=None,
                **fw_kw) -> Dict:
    """Live-encoder refinement (§3.4): continue from cached layer-``start``
    activations to the full-depth embedding: {"emb": (B, E), "h"}. The
    layers run on the same inputs as a full pass, so ``h`` and the last
    pooled state equal ``encode_exits``' bit for bit."""
    out = forward_hidden(params, cfg, recall, embeds=h_cached, mask=mask,
                         lora=lora, layer_start=start, collect_pooled=True,
                         **fw_kw)
    emb = exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
    return {"emb": emb, "h": out["h"]}


# ---------------------------------------------------------------------------
# LM loss and serving steps
# ---------------------------------------------------------------------------


def lm_head(params: Schema, cfg: LMConfig) -> torch.Tensor:
    """The (d, V) logits head: the embedding table's transpose when tied."""
    if cfg.tie_embeddings or "lm_head" not in params:
        return params["embed"].T
    return params["lm_head"]


def chunked_xent(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 chunk: int = 1024) -> torch.Tensor:
    """Mean token cross-entropy of ``h`` (B, S, D) through ``head`` (D, V)
    without the whole (B, S, V) logits: S in chunks of ``chunk`` (which
    must divide it), each chunk's logits made in h's dtype, then taken to
    float32. ``mask`` (B, S) weights the tokens (the mean is over its
    sum)."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S {S}")
    head = head.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        logits = (h[:, c:c + chunk] @ head).float()        # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, c:c + chunk].long()[..., None])[..., 0]
        if mask is None:
            tot = tot + (lse - ll).sum()
            cnt = cnt + lse.numel()
        else:
            m = mask[:, c:c + chunk].float()
            tot = tot + ((lse - ll) * m).sum()
            cnt = cnt + m.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params: Schema, cfg: LMConfig, recall: RecallConfig,
            tokens: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, *, chunk: int = 1024,
            lora=None, remat: bool = False, window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(xent + the MoE aux loss, {"xent", "aux"}) of next-token
    ``labels`` (B, S) for ``tokens`` (B, S)."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, mask=mask,
                         lora=lora, remat=remat, window=window)
    h = L.rmsnorm(out["h"], params["final_norm"], cfg.norm_eps)
    loss = chunked_xent(h, lm_head(params, cfg), labels, mask, chunk=chunk)
    return loss + out["aux"], {"xent": loss, "aux": out["aux"]}


def prefill(params: Schema, cfg: LMConfig, recall: RecallConfig,
            tokens: torch.Tensor, pad_to: Optional[int] = None, **fw_kw):
    """Prefill: the KV caches (L, B, max(S, pad_to), KV, hd), zero past S,
    the final hidden, the exit embeddings (n_exits, B, E) and the aux loss.
    The caches are allocated once at their padded size and each layer's k/v
    written into them (the reference stacks, then pads)."""
    B, S = tokens.shape
    S_cache = max(S, pad_to or 0)
    shape = (cfg.n_layers, B, S_cache, cfg.n_kv_heads, cfg.head_dim)
    dt = L.torch_dtype(cfg.dtype)
    with span("lm.caches"):
        caches = (torch.zeros(shape, dtype=dt, device=tokens.device),
                  torch.zeros(shape, dtype=dt, device=tokens.device))
    out = forward_hidden(params, cfg, recall, tokens=tokens, return_kv=True,
                         kv_cache=caches, collect_pooled=True, **fw_kw)
    exits = recall.exit_layers(cfg.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=tokens.device)
    embs = exit_embedding(params, out["pooled"][idx], cfg.norm_eps)
    return {"k_cache": caches[0], "v_cache": caches[1], "h": out["h"],
            "exit_embs": embs, "aux": out["aux"]}


def decode_step(params: Schema, cfg: LMConfig, recall: RecallConfig,
                token: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *, lora=None,
                window: Optional[int] = None):
    """token (B,); caches (L,B,S,KV,hd); lengths (B,) incl. the new token.
    Returns (logits (B,V) f32, k_cache, v_cache): the caches are the same
    tensors, the new token's k/v written in place. ``lora`` adds its deltas
    at the scale of the default ``RecallConfig()``, not ``recall``'s, as the
    reference's ``decode_step`` does."""
    lora_scale = RecallConfig().lora_alpha / RecallConfig().lora_rank
    with span("lm.embed"):
        x = L.embed_lookup(params["embed"], token[:, None]).to(
            L.torch_dtype(cfg.dtype))
    window = cfg.window if window is None else window
    lengths = lengths.to(torch.int32)
    for i in range(cfg.n_layers):
        x, _ = layer_decode(layer_slice(params["layers"], i), x, k_cache[i],
                            v_cache[i], lengths, cfg, window=window,
                            lora=layer_slice(lora, i) if lora else None,
                            lora_scale=lora_scale)
    h = L.rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return h.float() @ lm_head(params, cfg).float(), k_cache, v_cache
