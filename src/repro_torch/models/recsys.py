"""RecSys model zoo: DLRM (MLPerf), BST, SASRec, DIEN.

The hot path is the sparse embedding lookup: ``embedding_bag`` is a
clamped gather (``layers.embed_lookup``, whose table gradient is summed in
fp32 in a fixed order) and a masked reduce over fixed slots;
``embedding_bag_ragged`` sums flat ids by segment (``layers.segment_sum``).
``retrieval_scores`` scores each query against a (C, D) candidate bank in
one product; the step takes its top 100 (``launch/steps``). No op here has
a hand-written kernel: the reference reaches none of its Pallas kernels on
these models (its attention is the plain ``multihead_attention``, its
retrieval top-k ``lax.top_k``). DIEN's two recurrences are Python loops
over the sequence (the reference's ``lax.scan``), unrematerialised as the
reference's: at ``train_batch`` (65,536) autograd keeps about 38 GiB for
them, reckoned from the saved tensors of a CPU step at batch 256.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema

# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """Fixed-slot multi-hot bag: ids (B, L) -> (B, D)."""
    rows = L.embed_lookup(table, ids)  # (B, L, D)
    if mask is not None:
        rows = rows * mask[..., None].to(rows.dtype)
    s = rows.sum(dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        n = (mask.sum(dim=1, keepdim=True) if mask is not None
             else torch.full((ids.shape[0], 1), float(ids.shape[1]),
                             dtype=rows.dtype, device=rows.device))
        return s / torch.clamp_min(n, 1.0)
    raise ValueError(mode)


def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         weights: Optional[torch.Tensor] = None,
                         mode: str = "sum") -> torch.Tensor:
    """Ragged bag: flat ids (T,) grouped by segment_ids (T,) -> (num_bags,
    D); a segment id outside [0, num_bags) is dropped."""
    rows = L.embed_lookup(table, ids)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    s = L.segment_sum(rows, segment_ids, num_bags)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = L.segment_sum(torch.ones(segment_ids.shape, dtype=rows.dtype,
                                       device=rows.device),
                            segment_ids, num_bags)
        return s / torch.clamp_min(cnt[:, None], 1.0)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Small encoder block (BST / SASRec)
# ---------------------------------------------------------------------------


def _block_schema(d: int, n_heads: int, d_ff: int) -> Schema:
    return {
        "attn": L.attn_schema(d, n_heads, n_heads, d // n_heads,
                              qkv_bias=True),
        "ln1_s": ParamDef((d,), ("embed",), "ones"),
        "ln1_b": ParamDef((d,), ("embed",), "zeros"),
        "ln2_s": ParamDef((d,), ("embed",), "ones"),
        "ln2_b": ParamDef((d,), ("embed",), "zeros"),
        "ffn": L.mlp_schema((d, d_ff, d)),
    }


def _block_apply(p: Schema, x: torch.Tensor, *, causal: bool) -> torch.Tensor:
    B, S, d = x.shape
    h = L.layernorm(x, p["ln1_s"], p["ln1_b"])
    q, k, v = L.attn_project_qkv(p["attn"], h, rope_theta=0.0,
                                 positions=None)
    mask = L.attention_scores_mask(S, S, causal=causal, device=x.device)
    o = L.multihead_attention(q, k, v, mask=mask)
    x = x + L.attn_output(p["attn"], o)
    h = L.layernorm(x, p["ln2_s"], p["ln2_b"])
    return x + L.mlp_apply(p["ffn"], h, act=L.gelu)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091, MLPerf config)
# ---------------------------------------------------------------------------


def dlrm_schema(cfg: RecsysConfig) -> Schema:
    D = cfg.embed_dim
    s: Schema = {"tables": {
        f"t{i:02d}": ParamDef((v, D), ("table_rows", "embed"), "embed")
        for i, v in enumerate(cfg.table_vocabs)}}
    s["bot"] = L.mlp_schema((cfg.n_dense,) + cfg.bot_mlp)
    n_f = len(cfg.table_vocabs) + 1
    n_inter = n_f * (n_f - 1) // 2
    s["top"] = L.mlp_schema((cfg.bot_mlp[-1] + n_inter,) + cfg.top_mlp)
    return s


def dlrm_forward(params: Schema, cfg: RecsysConfig,
                 inputs: Dict) -> torch.Tensor:
    dense, sparse = inputs["dense"], inputs["sparse"]  # (B,13), (B,26)
    d = L.mlp_apply(params["bot"], dense, act=torch.relu, final_act=True)
    embs = [embedding_bag(params["tables"][f"t{i:02d}"], sparse[:, i:i + 1])
            for i in range(len(cfg.table_vocabs))]
    x = torch.stack([d] + embs, dim=1)  # (B, 27, D)
    z = torch.bmm(x, x.transpose(1, 2))  # (B, 27, 27)
    iu, ju = torch.triu_indices(x.shape[1], x.shape[1], offset=1,
                                device=x.device)  # row-major, as numpy's
    inter = z[:, iu, ju]  # (B, n_inter)
    top_in = torch.cat([d, inter], dim=-1)
    logit = L.mlp_apply(params["top"], top_in, act=torch.relu)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# BST (arXiv:1905.06874)
# ---------------------------------------------------------------------------

BST_OTHER_DIM = 64  # user/item/context "other features" side input


def bst_schema(cfg: RecsysConfig) -> Schema:
    D = cfg.embed_dim
    S = cfg.seq_len + 1  # behaviour sequence + target item
    d_ff = 4 * D
    return {
        "item_emb": ParamDef((cfg.item_vocab, D), ("table_rows", "embed"),
                             "embed"),
        "pos_emb": ParamDef((S, D), ("seq", "embed"), "embed"),
        "blocks": {f"b{i}": _block_schema(D, cfg.n_heads, d_ff)
                   for i in range(cfg.n_blocks)},
        "mlp": L.mlp_schema((S * D + BST_OTHER_DIM,) + cfg.mlp + (1,)),
    }


def _leaky_relu(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.01)


def bst_forward(params: Schema, cfg: RecsysConfig,
                inputs: Dict) -> torch.Tensor:
    hist, target = inputs["hist"], inputs["target"]  # (B,S), (B,)
    other = inputs["other"]  # (B, BST_OTHER_DIM)
    seq = torch.cat([hist, target[:, None].to(hist.dtype)], dim=1)
    x = L.embed_lookup(params["item_emb"], seq)
    x = x + params["pos_emb"][None]
    for i in range(cfg.n_blocks):
        x = _block_apply(params["blocks"][f"b{i}"], x, causal=False)
    flat = x.reshape(x.shape[0], -1)
    mlp_in = torch.cat([flat, other.to(flat.dtype)], dim=-1)
    logit = L.mlp_apply(params["mlp"], mlp_in, act=_leaky_relu)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# ---------------------------------------------------------------------------


def sasrec_schema(cfg: RecsysConfig) -> Schema:
    D = cfg.embed_dim
    return {
        "item_emb": ParamDef((cfg.item_vocab, D), ("table_rows", "embed"),
                             "embed"),
        "pos_emb": ParamDef((cfg.seq_len, D), ("seq", "embed"), "embed"),
        "blocks": {f"b{i}": _block_schema(D, cfg.n_heads, D)
                   for i in range(cfg.n_blocks)},
        "ln_f_s": ParamDef((D,), ("embed",), "ones"),
        "ln_f_b": ParamDef((D,), ("embed",), "zeros"),
    }


def sasrec_hidden(params: Schema, cfg: RecsysConfig,
                  hist: torch.Tensor) -> torch.Tensor:
    x = L.embed_lookup(params["item_emb"], hist) + params["pos_emb"][None]
    for i in range(cfg.n_blocks):
        x = _block_apply(params["blocks"][f"b{i}"], x, causal=True)
    return L.layernorm(x, params["ln_f_s"], params["ln_f_b"])


def sasrec_forward(params: Schema, cfg: RecsysConfig,
                   inputs: Dict) -> torch.Tensor:
    """Pointwise score of `target` given history (serving)."""
    h = sasrec_hidden(params, cfg, inputs["hist"])[:, -1]  # (B, D)
    t = L.embed_lookup(params["item_emb"], inputs["target"])
    return torch.sum(h * t, dim=-1)


def sasrec_loss(params: Schema, cfg: RecsysConfig,
                batch: Dict) -> torch.Tensor:
    """BCE over (pos, neg) next-item pairs at every position."""
    h = sasrec_hidden(params, cfg, batch["hist"])  # (B,S,D)
    pos = L.embed_lookup(params["item_emb"], batch["pos"])  # (B,S,D)
    neg = L.embed_lookup(params["item_emb"], batch["neg"])
    sp = torch.sum(h * pos, -1)
    sn = torch.sum(h * neg, -1)
    m = batch.get("mask")
    m = torch.ones_like(sp) if m is None else m.to(sp.dtype)
    loss = -(F.logsigmoid(sp) + F.logsigmoid(-sn)) * m
    return loss.sum() / torch.clamp_min(m.sum(), 1.0)


# ---------------------------------------------------------------------------
# DIEN (arXiv:1809.03672): GRU interest extraction + AUGRU evolution
# ---------------------------------------------------------------------------

def _gru_schema(d_in: int, d_h: int) -> Schema:
    return {
        "wz": ParamDef((d_in, d_h), ("embed", "hidden"), "fan_in"),
        "uz": ParamDef((d_h, d_h), ("hidden", "hidden"), "fan_in"),
        "bz": ParamDef((d_h,), ("hidden",), "zeros"),
        "wr": ParamDef((d_in, d_h), ("embed", "hidden"), "fan_in"),
        "ur": ParamDef((d_h, d_h), ("hidden", "hidden"), "fan_in"),
        "br": ParamDef((d_h,), ("hidden",), "zeros"),
        "wn": ParamDef((d_in, d_h), ("embed", "hidden"), "fan_in"),
        "un": ParamDef((d_h, d_h), ("hidden", "hidden"), "fan_in"),
        "bn": ParamDef((d_h,), ("hidden",), "zeros"),
    }


def _gru_cell(p: Schema, h: torch.Tensor, x: torch.Tensor,
              update_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    z = torch.sigmoid(x @ p["wz"] + h @ p["uz"] + p["bz"])
    r = torch.sigmoid(x @ p["wr"] + h @ p["ur"] + p["br"])
    n = torch.tanh(x @ p["wn"] + (r * h) @ p["un"] + p["bn"])
    if update_scale is not None:  # AUGRU: attention-scaled update gate
        z = z * update_scale[:, None]
    return (1.0 - z) * h + z * n


def _recur(p: Schema, h: torch.Tensor, xs: torch.Tensor,
           scales: Optional[torch.Tensor] = None):
    """``_gru_cell`` over xs (B, S, d_in) from h (B, H), with AUGRU
    ``scales`` (B, S) if given: (final h, [the S states])."""
    states = []
    for t in range(xs.shape[1]):
        h = _gru_cell(p, h, xs[:, t], None if scales is None
                      else scales[:, t])
        states.append(h)
    return h, states


def dien_schema(cfg: RecsysConfig) -> Schema:
    D, H = cfg.embed_dim, cfg.gru_dim
    cate_vocab = max(cfg.item_vocab // 100, 16)
    d_in = 2 * D  # item + category embedding
    return {
        "item_emb": ParamDef((cfg.item_vocab, D), ("table_rows", "embed"),
                             "embed"),
        "cate_emb": ParamDef((cate_vocab, D), ("table_rows", "embed"),
                             "embed"),
        "gru1": _gru_schema(d_in, H),
        "gru2": _gru_schema(H, H),
        "att_w": ParamDef((H, d_in), ("hidden", "embed"), "fan_in"),
        "mlp": L.mlp_schema((H + d_in,) + cfg.mlp + (1,)),
        "retrieval_proj": ParamDef((H, D), ("hidden", "embed"), "fan_in"),
    }


def _dien_items(params: Schema, items: torch.Tensor,
                cates: torch.Tensor) -> torch.Tensor:
    return torch.cat([L.embed_lookup(params["item_emb"], items),
                      L.embed_lookup(params["cate_emb"], cates)], dim=-1)


def dien_forward(params: Schema, cfg: RecsysConfig,
                 inputs: Dict) -> torch.Tensor:
    x = _dien_items(params, inputs["hist"], inputs["hist_cate"])  # (B,S,2D)
    tgt = _dien_items(params, inputs["target"], inputs["target_cate"])
    h0 = x.new_zeros((x.shape[0], cfg.gru_dim))
    interests = torch.stack(_recur(params["gru1"], h0, x)[1], dim=1)
    att = torch.einsum("bsh,hd,bd->bs", interests, params["att_w"], tgt)
    att = torch.softmax(att, dim=-1)  # (B,S)
    h_final, _ = _recur(params["gru2"], h0, interests, att)
    mlp_in = torch.cat([h_final, tgt], dim=-1)
    logit = L.mlp_apply(params["mlp"], mlp_in, act=torch.relu)
    return logit[:, 0]


# ---------------------------------------------------------------------------
# Unified dispatch
# ---------------------------------------------------------------------------


def recsys_schema(cfg: RecsysConfig) -> Schema:
    return {"dlrm": dlrm_schema, "bst": bst_schema, "sasrec": sasrec_schema,
            "dien": dien_schema}[cfg.kind](cfg)


def recsys_init(gen: torch.Generator, cfg: RecsysConfig, *, device="cuda"):
    """Random params from ``gen`` (a generator on ``device``), in the
    config's dtype."""
    return L.init_params(gen, recsys_schema(cfg),
                         dtype=L.torch_dtype(cfg.dtype), device=device)


def recsys_specs(cfg: RecsysConfig):
    return L.param_specs(recsys_schema(cfg))


def recsys_forward(params, cfg: RecsysConfig, inputs: Dict) -> torch.Tensor:
    """(B,) logits (SASRec: the target's score)."""
    return {"dlrm": dlrm_forward, "bst": bst_forward, "sasrec": sasrec_forward,
            "dien": dien_forward}[cfg.kind](params, cfg, inputs)


def recsys_loss(params, cfg: RecsysConfig,
                batch: Dict) -> Tuple[torch.Tensor, Dict]:
    if cfg.kind == "sasrec":
        return sasrec_loss(params, cfg, batch), {}
    logit = recsys_forward(params, cfg, batch)
    y = batch["label"].float()
    loss = torch.mean(-(y * F.logsigmoid(logit)
                        + (1 - y) * F.logsigmoid(-logit)))
    return loss, {}


def user_vector(params, cfg: RecsysConfig, inputs: Dict) -> torch.Tensor:
    """Two-tower user representation in item-embedding space."""
    if cfg.kind == "dlrm":
        return L.mlp_apply(params["bot"], inputs["dense"], act=torch.relu,
                           final_act=True)
    if cfg.kind == "bst":
        x = L.embed_lookup(params["item_emb"], inputs["hist"])
        x = x + params["pos_emb"][None, :x.shape[1]]
        for i in range(cfg.n_blocks):
            x = _block_apply(params["blocks"][f"b{i}"], x, causal=False)
        return x.mean(dim=1)
    if cfg.kind == "sasrec":
        return sasrec_hidden(params, cfg, inputs["hist"])[:, -1]
    if cfg.kind == "dien":
        x = _dien_items(params, inputs["hist"], inputs["hist_cate"])
        h, _ = _recur(params["gru1"], x.new_zeros((x.shape[0], cfg.gru_dim)),
                      x)
        return h @ params["retrieval_proj"]
    raise ValueError(cfg.kind)


def candidate_matrix(params, cfg: RecsysConfig,
                     n_candidates: int) -> torch.Tensor:
    table = params["tables"]["t00"] if cfg.kind == "dlrm" \
        else params["item_emb"]
    return table[:n_candidates]


def retrieval_scores(params, cfg: RecsysConfig, inputs: Dict,
                     n_candidates: int) -> torch.Tensor:
    """(B, n_candidates) similarity of each query vs the candidate corpus:
    ``inputs["cand_bank"]`` (a (C, D) embedding bank, the production
    layout) or, at test scale, a slice of the item table."""
    u = user_vector(params, cfg, inputs)  # (B, D)
    c = inputs.get("cand_bank")
    if c is None:
        c = candidate_matrix(params, cfg, n_candidates)
    return u @ c.T
