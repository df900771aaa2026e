"""Transformer stack (decoder LM / bidirectional encoder) with Recall exits.

Layer parameters are *stacked* (leading ``n_layers`` dim, the reference's
layout); ``forward_hidden`` runs layers ``[layer_start, layer_end)`` as a
Python loop over that dim, which is how coarse (early-exited) encoding and
live-encoder refinement (paper §3.4) reuse one weight set. The LM serving
path is ``prefill`` (a prompt batch into preallocated, padded caches,
with the exit embeddings) and ``decode_step`` (one greedy token against
those caches, written in place).

A layer's attention half and the caches are the config's attention kind
(``models/attention.py``: GQA or MLA; a hybrid's KDA layers, their own
parameter stack ``kda`` beside ``attn``, carry a recurrent state in
their caches instead of rows); the norms go through the rmsnorm
kernel's dispatch, MoE layers through the grouped expert GEMM's
(``models/moe.py``). The first ``n_dense_layers(cfg)`` layers are dense
SwiGLUs (the ``mlp`` stack), the rest MoE layers (the ``moe`` stack).

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
nothing; an MLA layer refuses any other. Flash attention and RMSNorm are
differentiable (their backward kernels), so a loss on ``forward_hidden``
trains the LoRA on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LMConfig, RecallConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span


def n_dense_layers(cfg: LMConfig) -> int:
    """How many first layers are dense SwiGLUs (the ``mlp`` stack), the
    rest MoE layers (the ``moe`` stack): all of a dense config's, the
    first ``first_k_dense`` of an MoE config's."""
    return cfg.n_layers if cfg.moe is None else cfg.first_k_dense


def lm_schema(cfg: LMConfig, recall: RecallConfig, *, embed_out: int = 1024,
              with_lm_head: bool = True) -> Schema:
    Ld = (cfg.n_layers,)
    k = n_dense_layers(cfg)
    layer: Schema = {
        "norm1": L.rmsnorm_schema(cfg.d_model, Ld),
        "norm2": L.rmsnorm_schema(cfg.d_model, Ld),
    }
    sizes = A.stack_sizes(cfg)
    for name, att in A.stacks(cfg).items():
        layer[name] = att.schema((sizes[name],))
    if k:
        layer["mlp"] = L.swiglu_schema(cfg.d_model, cfg.d_ff, layer_dims=(k,))
    if cfg.moe is not None:
        layer["moe"] = MOE.moe_schema(cfg.d_model, cfg.moe,
                                      layer_dims=(cfg.n_layers - k,),
                                      router=cfg.router)
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


def layer_params(layers: Schema, i: int, cfg: LMConfig) -> Schema:
    """Layer ``i``'s params: ``layer_slice`` of the norms; of the
    attention stacks, the one that holds the layer
    (``attention.layer_stack``: ``attn``, or a hybrid's ``kda``) at its
    position there; of the FFN ones, the one the layer has: ``mlp`` (the
    first ``n_dense_layers``) or ``moe`` (the rest, indexed from
    there)."""
    k = n_dense_layers(cfg)
    out = {n: layer_slice(v, i) for n, v in layers.items()
           if n not in ("mlp", "moe", "attn", "kda")}
    name, j = A.layer_stack(cfg, i)
    out[name] = layer_slice(layers[name], j)
    if i < k:
        out["mlp"] = layer_slice(layers["mlp"], i)
    else:
        out["moe"] = layer_slice(layers["moe"], i - k)
    return out


def _mlp_half(pl_: Schema, x: torch.Tensor, cfg: LMConfig,
              lora: Optional[Dict], lora_scale: float):
    """norm2, then the MoE layer (aux its loss; LoRA has no MoE target; a
    ``router`` config's layer is dropless, aux 0) or the dense SwiGLU (aux
    None), then the residual -> (x, aux)."""
    with span("layer.mlp"):
        h = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
        if "mlp" in pl_:
            y, aux = L.swiglu(pl_["mlp"], h, lora, lora_scale), None
        elif cfg.router is not None:
            y, aux = MOE.moe_apply_dropless(pl_["moe"], h, cfg.moe,
                                            cfg.router)
        else:
            y, aux = MOE.moe_apply(pl_["moe"], h, cfg.moe)
        return x + y, aux


def layer_full(pl_: Schema, x: torch.Tensor, cfg: LMConfig, positions, *,
               window: int, lora=None, lora_scale=0.0, cache=None):
    """Self-attention layer over the full (own) sequence -> (x, aux or
    None, rows). ``lora`` is this layer's slice, ``cache`` this layer's
    caches (B, S' >= S, ...) to fill or None; ``rows`` is what the kind
    leaves the caller to write into ``cache`` at [:, :S] (GQA: k, v)."""
    with span("layer.attn"):
        h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
        name = "kda" if "kda" in pl_ else "attn"
        y, rows = A.stacks(cfg)[name].full(pl_[name], h, positions,
                                           window=window, lora=lora,
                                           lora_scale=lora_scale,
                                           cache=cache)
        x = x + y
    return (*_mlp_half(pl_, x, cfg, lora, lora_scale), rows)


def layer_decode(pl_: Schema, x: torch.Tensor, cache: Tuple, lengths,
                 cfg: LMConfig, *, window: int, lora=None, lora_scale=0.0):
    """One-token step -> (x, aux or None). x (B,1,d); ``cache`` this
    layer's caches (B, S, ...), the new token's rows written in place at
    lengths-1 (``attention._cache_row``); lengths (B,) int32 is the
    sequence length *including* the new token."""
    with span("layer.attn"):
        h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
        name = "kda" if "kda" in pl_ else "attn"
        x = x + A.stacks(cfg)[name].decode(pl_[name], h, lengths, cache,
                                           window=window, lora=lora,
                                           lora_scale=lora_scale)
    return _mlp_half(pl_, x, cfg, lora, lora_scale)


def forward_hidden(params: Schema, cfg: LMConfig, recall: RecallConfig, *,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   lora=None,
                   layer_start: int = 0, layer_end: Optional[int] = None,
                   collect_pooled: bool = False, pool: str = "mean",
                   return_kv: bool = False,
                   kv_cache: Optional[Tuple[torch.Tensor, ...]] = None,
                   remat: bool = False,
                   window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Run layers [layer_start, layer_end) on ``embeds`` (B, S, d) or on
    the embedding rows of ``tokens`` (B, S). Returns {"h": (B, S, d) final
    hidden, "aux": f32 scalar (the MoE layers' aux loss), "pooled":
    (L', B, d) per-layer pooled hidden (if collect_pooled; ``mask`` (B, S)
    makes the mean pool a masked mean), "kv": the attention kind's caches
    (L', B, S', ...) in its ``cache_names`` order (if return_kv)}. With
    ``kv_cache`` (such a tuple) the layers' rows are written into those
    caches at [i - layer_start, :, :S] (S' >= S; a prefill into
    preallocated padded caches); without it ``attention.new_caches`` of
    exactly S are made. ``lora`` (stacked over all n_layers) adds its
    deltas at scale ``recall.lora_alpha / recall.lora_rank``. ``remat``
    keeps no layer's activations for the backward but its input, and runs
    the layer again there."""
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
        kv_cache = A.new_caches(cfg, layer_end - layer_start, B, S,
                                x.device)
    if return_kv and cfg.kda is not None and layer_start:
        raise NotImplementedError("a hybrid's caches from layer 0 only")
    lora_scale = recall.lora_alpha / recall.lora_rank
    pooled, aux = [], None
    for i in range(layer_start, layer_end):
        cache = (A.layer_caches(cfg, kv_cache, i - layer_start) if return_kv
                 else None)
        run = lambda x_, p_, l_: layer_full(p_, x_, cfg, positions,
                                            window=window, lora=l_,
                                            lora_scale=lora_scale,
                                            cache=cache)
        p_i = layer_params(params["layers"], i, cfg)
        l_i = layer_slice(lora, i) if lora else None
        if remat and torch.is_grad_enabled():
            x, aux_l, rows = torch.utils.checkpoint.checkpoint(
                run, x, p_i, l_i, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux_l, rows = run(x, p_i, l_i)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        if return_kv and rows:
            with span("layer.kv_write"):
                for c, r in zip(cache, rows):
                    c[:, :S] = r
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
    """Prefill: the attention stacks' caches (``attention.cache_names``;
    a row cache (L, B, max(S, pad_to), ...), zero past S; KDA's states and
    conv tails after the prompt), the final hidden, the exit
    embeddings (n_exits, B, E) and the aux loss. The caches are allocated
    once at their padded size (the reference stacks, then pads)."""
    B, S = tokens.shape
    with span("lm.caches"):
        caches = A.new_caches(cfg, cfg.n_layers, B, max(S, pad_to or 0),
                            tokens.device)
    out = encode_exits(params, cfg, recall, tokens=tokens, return_kv=True,
                       kv_cache=caches, **fw_kw)
    return {**dict(zip(A.cache_names(cfg), caches)), "h": out["h"],
            "exit_embs": out["exit_embs"], "aux": out["aux"]}


def decode_step(params: Schema, cfg: LMConfig, recall: RecallConfig,
                token: torch.Tensor, *caches_and_lengths: torch.Tensor,
                lora=None, window: Optional[int] = None):
    """token (B,), the attention stacks' caches in ``attention.cache_names``
    order, lengths (B,) incl. the new token -> (logits
    (B,V) f32, *caches), the same tensors, the new token's rows written in
    place. ``lora`` adds its deltas at the scale of the default
    ``RecallConfig()``, not ``recall``'s, as the reference's does."""
    *caches, lengths = caches_and_lengths
    lora_scale = RecallConfig().lora_alpha / RecallConfig().lora_rank
    with span("lm.embed"):
        x = L.embed_lookup(params["embed"], token[:, None]).to(
            L.torch_dtype(cfg.dtype))
    window = cfg.window if window is None else window
    lengths = lengths.to(torch.int32)
    for i in range(cfg.n_layers):
        x, _ = layer_decode(layer_params(params["layers"], i, cfg), x,
                            A.layer_caches(cfg, caches, i), lengths, cfg,
                            window=window,
                            lora=layer_slice(lora, i) if lora else None,
                            lora_scale=lora_scale)
    h = L.rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return (h.float() @ lm_head(params, cfg).float(), *caches)
