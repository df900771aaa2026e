"""ImageBind-style multimodal embedding model (MEM), encoder side.

Per-modality transformer towers bind into one shared embedding space.
Modality frontends are stubs: ``inputs`` is precomputed patch/frame
features for vision/audio/imu and token ids for text; each tower prepends a
CLS token, adds learned positions and runs the transformer stack, so the
Recall machinery (exit taps, prefix/suffix layer ranges) applies per tower.

Activations keep the dtype the reference's promotion gives them, and every
layer casts its weights to it: in a bf16 config the text tower (a bf16
token lookup) runs in bf16, while fp32 stub features and a resumed fp32
hidden state (the dequantized activation cache) keep the vision tower and
refinement in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig, MEMConfig, RecallConfig, TowerConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import ParamDef, Schema


def tower_lm_cfg(t: TowerConfig, mem: MEMConfig) -> LMConfig:
    """Encoder-flavoured LMConfig for one tower (bidirectional, no RoPE)."""
    return LMConfig(
        n_layers=t.n_layers, d_model=t.d_model, n_heads=t.n_heads,
        n_kv_heads=t.n_heads, d_ff=t.d_ff, vocab=max(t.vocab, 1),
        causal=False, rope_theta=0.0, dtype=mem.dtype, norm_eps=mem.norm_eps)


def tower_schema(t: TowerConfig, mem: MEMConfig, recall: RecallConfig) -> Schema:
    cfg = tower_lm_cfg(t, mem)
    s = T.lm_schema(cfg, recall, embed_out=mem.embed_dim,
                    with_lm_head=False)
    del s["embed"]
    if t.vocab:  # discrete-token frontend
        s["tok_emb"] = ParamDef((t.vocab, t.d_model), ("vocab", "embed"), "embed")
    else:        # stub frontend: precomputed frame/patch/token embeddings
        s["proj_in"] = ParamDef((t.d_input, t.d_model), ("act_embed", "embed"), "fan_in")
    s["cls"] = ParamDef((1, t.d_model), (None, "embed"), "normal", 0.02)
    s["pos"] = ParamDef((t.n_tokens + 1, t.d_model), ("seq", "embed"), "normal", 0.02)
    return s


def mem_schema(cfg: MEMConfig, recall: RecallConfig) -> Schema:
    return {
        "towers": {t.modality: tower_schema(t, cfg, recall) for t in cfg.towers},
        "logit_scale": ParamDef((), (), "zeros"),
    }


def mem_init(gen: torch.Generator, cfg: MEMConfig, recall: RecallConfig,
             device="cuda"):
    """Random MEM params from ``gen`` (a generator on ``device``)."""
    dtype = L.torch_dtype(cfg.dtype)
    p = L.init_params(gen, mem_schema(cfg, recall), dtype=dtype, device=device)
    p["logit_scale"] = torch.tensor(math.log(cfg.logit_scale_init),
                                    dtype=torch.float32,
                                    device=device).to(dtype)
    return p


def mem_specs(cfg: MEMConfig, recall: RecallConfig):
    return L.param_specs(mem_schema(cfg, recall))


def _frontend(tp: Schema, t: TowerConfig, inputs: torch.Tensor) -> torch.Tensor:
    """inputs -> (B, n_tokens+1, d_model) with CLS prepended, in the token
    table's dtype (text) or the stub features' dtype (other towers)."""
    if t.vocab:
        x = L.embed_lookup(tp["tok_emb"], inputs)
    else:
        x = inputs @ tp["proj_in"].to(inputs.dtype)
    B = x.shape[0]
    cls = tp["cls"][None].expand(B, 1, x.shape[-1]).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    return x + tp["pos"][None, : x.shape[1]].to(x.dtype)


def tower_forward(params: Schema, cfg: MEMConfig, recall: RecallConfig,
                  modality: str, inputs: Optional[torch.Tensor], *,
                  layer_start: int = 0, layer_end: Optional[int] = None,
                  h_state: Optional[torch.Tensor] = None,
                  lora: Optional[Dict] = None, collect_pooled: bool = True,
                  remat: bool = False):
    """Generic tower run over layers [start, end); ``h_state`` skips the
    frontend (cached-activation reuse, §3.4); ``lora`` is the tower's
    stacked LoRA (P-LoRA healing); ``remat`` recomputes each layer in the
    backward (``transformer.forward_hidden``)."""
    t = cfg.tower(modality)
    tcfg = tower_lm_cfg(t, cfg)
    tp = params["towers"][modality]
    x = _frontend(tp, t, inputs) if h_state is None else h_state
    return T.forward_hidden(tp, tcfg, recall, embeds=x, lora=lora,
                            layer_start=layer_start, layer_end=layer_end,
                            collect_pooled=collect_pooled, pool="cls",
                            remat=remat)


def mem_embed(params: Schema, cfg: MEMConfig, recall: RecallConfig,
              modality: str, inputs: torch.Tensor, *,
              exit_layer: Optional[int] = None,
              lora: Optional[Dict] = None,
              remat: bool = False) -> torch.Tensor:
    """Fine-grained (exit_layer=None) or coarse embedding: (B, embed_dim)."""
    out = tower_forward(params, cfg, recall, modality, inputs,
                        layer_end=exit_layer, lora=lora, remat=remat)
    tp = params["towers"][modality]
    return T.exit_embedding(tp, out["pooled"][-1], cfg.norm_eps)


def mem_embed_all_exits(params: Schema, cfg: MEMConfig, recall: RecallConfig,
                        modality: str, inputs: torch.Tensor,
                        lora: Optional[Dict] = None):
    """(n_exits, B, E) embeddings at every exit + per-layer hidden pool."""
    t = cfg.tower(modality)
    out = tower_forward(params, cfg, recall, modality, inputs, lora=lora)
    exits = recall.exit_layers(t.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=out["pooled"].device)
    tp = params["towers"][modality]
    embs = T.exit_embedding(tp, out["pooled"][idx], cfg.norm_eps)
    return {"exit_embs": embs, "exits": exits, "pooled": out["pooled"]}


def mem_refine(params: Schema, cfg: MEMConfig, recall: RecallConfig,
               modality: str, h_cached: torch.Tensor, start: int,
               lora: Optional[Dict] = None) -> torch.Tensor:
    """Live-encoder refinement from cached layer-``start`` activations."""
    out = tower_forward(params, cfg, recall, modality, inputs=None,
                        h_state=h_cached, layer_start=start, lora=lora)
    tp = params["towers"][modality]
    return T.exit_embedding(tp, out["pooled"][-1], cfg.norm_eps)


def info_nce(za: torch.Tensor, zb: torch.Tensor,
             logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE between aligned batches of normalized embeddings."""
    scale = torch.exp(logit_scale.float())
    logits = scale * (za.float() @ zb.float().T)
    labels = torch.arange(za.shape[0], device=za.device)
    return 0.5 * (L.cross_entropy(logits, labels)
                  + L.cross_entropy(logits.T, labels))


def mem_contrastive_loss(params: Schema, cfg: MEMConfig, recall: RecallConfig,
                         batch: Dict[str, torch.Tensor], *,
                         anchor: str = "vision", lora: Optional[Dict] = None,
                         remat: bool = False
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ImageBind objective: bind every modality in ``batch`` to the anchor;
    the mean of the per-modality InfoNCE losses, and each one
    (``nce_<modality>``)."""
    za = mem_embed(params, cfg, recall, anchor, batch[anchor], lora=lora,
                   remat=remat)
    total = torch.zeros((), dtype=torch.float32, device=za.device)
    metrics, n = {}, 0
    for t in cfg.towers:
        m = t.modality
        if m == anchor or m not in batch:
            continue
        zb = mem_embed(params, cfg, recall, m, batch[m], lora=lora,
                       remat=remat)
        li = info_nce(za, zb, params["logit_scale"])
        metrics[f"nce_{m}"] = li
        total = total + li
        n += 1
    return total / max(n, 1), metrics
