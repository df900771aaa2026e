"""GatedGCN (Bresson & Laurent; arXiv:1711.07553 / benchmarking-gnns config).

Message passing over an explicit edge list (src, dst): the endpoint rows
are clamped gathers (``layers.embed_lookup``) and the messages are summed
into their destination by ``layers.segment_sum`` (a fixed-order
accumulating ``index_put_``, which drops a message whose dst lies outside
the graph). Residual + LayerNorm variant, as the reference's.

Recall integration: each message-passing round is an exit; coarse graph
embeddings are tapped per round through the shared exit head, whose
RMSNorm goes through the kernel dispatch (the Triton kernel on the card).

The layer parameters are stacked ``(L, d, d)`` leaves, run as a Python
loop over ``[layer_start, layer_end)``; ``remat`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant: nothing of the layer is saved
but its inputs, as the reference's ``nothing_saveable`` policy).
The batched forms (``gnn_forward_batched``) run the reference's ``vmap``
over graphs as one disjoint union: each graph's ids are clamped into its
own node range first, and a message whose dst lies outside its own graph
is dropped, as each graph's ``segment_sum`` drops it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import GNNConfig, RecallConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema


class Graph(NamedTuple):
    """Static-shape (padded) graph batch.

    node_feat: (N, F); src/dst: (E,) int edge endpoints (edge j->i is
    src=j, dst=i); node_mask/edge_mask: 1.0 for real entries, 0.0 padding;
    labels: (N,) int node labels (-1 where unlabeled). The batched forms
    take each field with a leading graph axis.
    """

    node_feat: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    labels: torch.Tensor


def gnn_schema(cfg: GNNConfig, recall: RecallConfig,
               embed_out: int = 1024) -> Schema:
    d = cfg.d_hidden
    Ld = (cfg.n_layers,)
    la = ("layer",)
    return {
        "w_in": ParamDef((cfg.d_feat, d), ("act_embed", "hidden"), "fan_in"),
        "b_in": ParamDef((d,), ("hidden",), "zeros"),
        "e_init": ParamDef((d,), ("hidden",), "normal", 0.02),
        "layers": {
            "A": ParamDef(Ld + (d, d), la + ("hidden", "mlp"), "fan_in"),
            "B": ParamDef(Ld + (d, d), la + ("hidden", "mlp"), "fan_in"),
            "C": ParamDef(Ld + (d, d), la + ("hidden", "mlp"), "fan_in"),
            "D": ParamDef(Ld + (d, d), la + ("hidden", "mlp"), "fan_in"),
            "E": ParamDef(Ld + (d, d), la + ("hidden", "mlp"), "fan_in"),
            "ln_h_s": ParamDef(Ld + (d,), la + ("hidden",), "ones"),
            "ln_h_b": ParamDef(Ld + (d,), la + ("hidden",), "zeros"),
            "ln_e_s": ParamDef(Ld + (d,), la + ("hidden",), "ones"),
            "ln_e_b": ParamDef(Ld + (d,), la + ("hidden",), "zeros"),
        },
        "head": ParamDef((d, cfg.n_classes), ("hidden", "act_embed"),
                         "fan_in"),
        "exit_head": {
            "norm": L.rmsnorm_schema(d),
            "proj": ParamDef((d, embed_out), ("hidden", "act_embed"),
                             "fan_in"),
        },
    }


def gnn_init(gen: torch.Generator, cfg: GNNConfig, recall: RecallConfig,
             embed_out: int = 1024, *, device="cuda"):
    """Random params from ``gen`` (a generator on ``device``), in the
    config's dtype."""
    return L.init_params(gen, gnn_schema(cfg, recall, embed_out),
                         dtype=L.torch_dtype(cfg.dtype), device=device)


def gnn_specs(cfg: GNNConfig, recall: RecallConfig, embed_out: int = 1024):
    return L.param_specs(gnn_schema(cfg, recall, embed_out))


def _layer(pl_: Schema, h: torch.Tensor, e: torch.Tensor, g: Graph,
           eps: float, n_nodes: int, seg_dst: torch.Tensor):
    """One GatedGCN round. h (N,d), e (E,d); ``seg_dst`` (E,) the ids the
    messages are summed into (``g.dst`` but for the batched union)."""
    hs = L.embed_lookup(h, g.src)  # (E, d)
    hd = L.embed_lookup(h, g.dst)
    e_pre = e @ pl_["C"] + hd @ pl_["D"] + hs @ pl_["E"]
    e_pre = L.layernorm(e_pre, pl_["ln_e_s"], pl_["ln_e_b"], eps)
    e_new = e + torch.relu(e_pre)
    eta = torch.sigmoid(e_new) * g.edge_mask[:, None].to(e_new.dtype)
    msg = eta * (hs @ pl_["B"])
    num = L.segment_sum(msg, seg_dst, n_nodes)
    den = L.segment_sum(eta, seg_dst, n_nodes)
    agg = num / (den + 1e-6)
    h_pre = L.layernorm(h @ pl_["A"] + agg, pl_["ln_h_s"], pl_["ln_h_b"],
                        eps)
    return h + torch.relu(h_pre), e_new


def _run(params: Schema, cfg: GNNConfig, g: Graph, n_graphs: int, *,
         layer_start: int = 0, layer_end: Optional[int] = None,
         e_state: Optional[torch.Tensor] = None,
         h_state: Optional[torch.Tensor] = None,
         collect_pooled: bool = False, remat: bool = False,
         seg_dst: Optional[torch.Tensor] = None):
    """Rounds [layer_start, layer_end) over ``g``, whose nodes are
    ``n_graphs`` graphs of equal size back to back: (h, e, [per round,
    each graph's masked-mean node state (n_graphs, d)])."""
    n_nodes = g.node_feat.shape[0]
    seg_dst = g.dst if seg_dst is None else seg_dst
    layer_end = cfg.n_layers if layer_end is None else layer_end
    if h_state is None:
        h = g.node_feat @ params["w_in"] + params["b_in"]
    else:
        h = h_state
    e = (params["e_init"].expand(g.src.shape[0], cfg.d_hidden)
         if e_state is None else e_state)
    m = g.node_mask.view(n_graphs, -1, 1).to(h.dtype)
    pooled = []
    for i in range(layer_start, layer_end):
        pl_ = {k: v[i] for k, v in params["layers"].items()}
        if remat and torch.is_grad_enabled():
            h, e = torch.utils.checkpoint.checkpoint(
                _layer, pl_, h, e, g, cfg.norm_eps, n_nodes, seg_dst,
                use_reentrant=False, preserve_rng_state=False)
        else:
            h, e = _layer(pl_, h, e, g, cfg.norm_eps, n_nodes, seg_dst)
        if collect_pooled:
            hg = h.view(n_graphs, -1, h.shape[-1])
            pooled.append((hg * m).sum(1) / torch.clamp_min(m.sum(1), 1.0))
    return h, e, pooled


def gnn_forward(params: Schema, cfg: GNNConfig, recall: RecallConfig,
                g: Graph, *, collect_pooled: bool = False,
                **kw) -> Dict[str, torch.Tensor]:
    """Returns dict: h (N,d), e (E,d), logits (N,C), pooled (L',d) graph
    embedding after each round run (if ``collect_pooled``). ``kw``:
    ``layer_start``/``layer_end`` (the rounds to run), ``h_state``/
    ``e_state`` (resume from a cached round's states; else the input
    projection and ``e_init``), ``remat``."""
    h, e, pooled = _run(params, cfg, g, 1, collect_pooled=collect_pooled,
                        **kw)
    out = {"h": h, "e": e, "logits": h @ params["head"]}
    if collect_pooled:
        out["pooled"] = torch.cat(pooled) if pooled else \
            h.new_zeros((0, h.shape[-1]))
    return out


def _node_loss(logits: torch.Tensor, labels: torch.Tensor,
               node_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked cross-entropy, accuracy) over the labelled real nodes."""
    valid = (labels >= 0) & (node_mask > 0)
    lab = torch.clamp_min(labels.long(), 0)
    loss = L.cross_entropy(logits, lab, mask=valid.float())
    acc = torch.sum((torch.argmax(logits, -1) == lab) & valid) \
        / torch.clamp_min(valid.sum(), 1)
    return loss, acc


def gnn_loss(params: Schema, cfg: GNNConfig, recall: RecallConfig, g: Graph,
             **kw) -> Tuple[torch.Tensor, Dict]:
    out = gnn_forward(params, cfg, recall, g, **kw)
    loss, acc = _node_loss(out["logits"], g.labels, g.node_mask)
    return loss, {"acc": acc}


def gnn_exit_embeddings(params: Schema, cfg: GNNConfig, recall: RecallConfig,
                        g: Graph) -> torch.Tensor:
    """Coarse graph embeddings at each exit round: (n_exits, E_out)."""
    out = gnn_forward(params, cfg, recall, g, collect_pooled=True)
    exits = recall.exit_layers(cfg.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=out["h"].device)
    h = L.rmsnorm(out["pooled"][idx], params["exit_head"]["norm"],
                  cfg.norm_eps)
    emb = h.float() @ params["exit_head"]["proj"].float()
    return L.l2_normalize(emb)


def union_graph(gs: Graph) -> Tuple[Graph, torch.Tensor]:
    """Batched graphs (each field with a leading axis of G graphs of N
    nodes and E edges) as one graph of G·N nodes, and the ids its messages
    are summed into. Graph b's ids are clamped into [0, N), as each
    graph's clamped gathers take them, then offset by b·N; a message whose
    dst lies outside [0, N) is summed into G·N, which ``segment_sum``
    drops, as each graph's own drops it."""
    G, N = gs.node_feat.shape[:2]
    off = (torch.arange(G, device=gs.src.device) * N)[:, None]
    src = gs.src.long().clamp(0, N - 1) + off
    dst = gs.dst.long()
    seg_dst = torch.where((dst >= 0) & (dst < N), dst + off, G * N)
    dst = dst.clamp(0, N - 1) + off
    return Graph(gs.node_feat.reshape(G * N, -1), src.reshape(-1),
                 dst.reshape(-1), gs.node_mask.reshape(-1),
                 gs.edge_mask.reshape(-1), gs.labels.reshape(-1)), \
        seg_dst.reshape(-1)


def gnn_forward_batched(params, cfg: GNNConfig, recall: RecallConfig,
                        gs: Graph, *, collect_pooled: bool = False,
                        **kw) -> Dict[str, torch.Tensor]:
    """The reference's ``vmap`` of ``gnn_forward`` over G graphs, run as
    one disjoint union (``union_graph``): h (G,N,d), e (G,E,d), logits
    (G,N,C), pooled (G,L',d) if ``collect_pooled``; ``h_state`` (G,N,d)
    and ``e_state`` (G,E,d) resume as in ``gnn_forward``."""
    G, N = gs.node_feat.shape[:2]
    E = gs.src.shape[1]
    for key, rows in (("h_state", G * N), ("e_state", G * E)):
        if kw.get(key) is not None:
            kw[key] = kw[key].reshape(rows, -1)
    u, seg_dst = union_graph(gs)
    h, e, pooled = _run(params, cfg, u, G, collect_pooled=collect_pooled,
                        seg_dst=seg_dst, **kw)
    out = {"h": h.view(G, N, -1), "e": e.reshape(G, E, -1),
           "logits": (h @ params["head"]).view(G, N, -1)}
    if collect_pooled:
        out["pooled"] = torch.stack(pooled, dim=1) if pooled else \
            h.new_zeros((G, 0, h.shape[-1]))
    return out


def gnn_loss_batched(params, cfg: GNNConfig, recall: RecallConfig, gs: Graph,
                     **kw) -> Tuple[torch.Tensor, Dict]:
    out = gnn_forward_batched(params, cfg, recall, gs, **kw)
    return _node_loss(out["logits"], gs.labels, gs.node_mask)[0], {}
