"""Step builders: one function per (arch x shape) cell, the counterpart
of the reference's ``launch/steps.py`` without mesh or shardings (one
device).

``build_step(spec, shape)`` returns a :class:`StepBundle` with the step
function, the analytic model FLOPs (the reference's convention) and meta
(the config the step runs, its device and token count; for the train
kinds and the gnn and recsys families ``inputs``, the name, shape and
dtype of each input the step takes, in place of the reference's abstract
arguments). The caller makes the parameters (``transformer.lm_init``,
``imagebind.mem_init``, ``recsys.recsys_init``, ``gnn.gnn_init`` on
``meta["device"]``), the optimizer state (``AdamW.init``) and inputs.
Every kind of every family is ported: ``lm`` (``train``, ``prefill``,
``decode``), ``mem`` (``serve``, ``train``, ``retrieval``), ``gnn``
(``graph_full``, ``graph_mini``, ``graph_batched``: train steps) and
``recsys`` (``train``, ``serve``, ``retrieval``). A train step is
``fn(params, opt_state, batch) -> (params, opt_state, {"loss",
"grad_norm", "lr"})`` with the reference's optimizer (``_opt``); the gnn
and recsys train steps update ``params`` and the moments in place, as the
reference donates them (``donate_argnums=(0, 1)``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ArchSpec, GNNConfig, LMConfig,
                                      MEMConfig, RecsysConfig, ShapeConfig)
from repro_torch.data.sampler import max_sizes
from repro_torch.models import gnn as G
from repro_torch.models import imagebind as IB
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.layers import torch_dtype
from repro_torch.optim.adamw import AdamW, _map, value_and_grad
from repro_torch.optim.schedule import warmup_cosine


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    model_flops: float           # analytic "useful" FLOPs (2ND / 6ND)
    meta: Dict[str, Any]


def _opt(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 20, total_steps), weight_decay=0.1,
                 clip_norm=1.0)


def _lm_cfg(spec: ArchSpec, n_layers: Optional[int]) -> LMConfig:
    return spec.model if n_layers is None else replace(spec.model,
                                                       n_layers=n_layers)


def _auto_lm_train_plan(cfg: LMConfig, B: int, S: int, dp: int, tp: int,
                        n_dev: int, budget: float = 13e9
                        ) -> Tuple[int, str]:
    """(microbatches, mode) whose estimated train-step memory fits
    ``budget`` bytes a device: the reference's arithmetic, number for
    number. mode "fsdp" chunks the cross-entropy over the sequence,
    "fsdp_seq" takes the whole sequence in one chunk. On one device every
    LM's weights, fp32 gradients and Adam state alone pass the budget, so
    the plan falls through to one sequence a microbatch, "fsdp_seq"."""
    tokens_local = B * S // dp
    P_bytes = cfg.n_params * 2.0
    opt_bytes = cfg.n_params * 8.0 / n_dev

    def est(mb: int, mode: str) -> float:
        seq_div = tp if mode == "fsdp_seq" else 1
        tl = tokens_local / mb / seq_div
        carry = cfg.n_layers * tl * cfg.d_model * 2
        if cfg.moe is not None:  # expert buffer ~= top_k x cf x token bytes
            carry += 2.0 * tl * cfg.d_model * 2 * cfg.moe.top_k \
                * cfg.moe.capacity_factor
        weights = P_bytes / n_dev
        grads32 = 2.0 * cfg.n_params * 4.0 / n_dev
        if mode == "fsdp_seq":
            xent = 3.0 * (tokens_local / mb) * (cfg.vocab / tp) * 4.0
        else:
            xent = 3.0 * min(1024, S) * (B / dp / mb) * (cfg.vocab / tp) * 4.0
        mult = 2.0 if mode == "fsdp_seq" else 4.0
        return mult * carry + 2e9 / seq_div + weights + opt_bytes + grads32 \
            + xent

    mb = 1
    while B // mb >= dp and (B % (mb * dp)) == 0:
        for mode in ("fsdp", "fsdp_seq"):
            if est(mb, mode) < budget:
                return mb, mode
        mb *= 2
    return max(B // dp, 1), "fsdp_seq"


def build_lm_train(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                   window: int = 0, n_layers: Optional[int] = None,
                   remat: bool = True, microbatches: int = 0) -> StepBundle:
    """fn(params, opt_state, {"tokens", "labels"} (B, S) int) -> (params,
    opt_state, {"loss", "grad_norm", "lr"}). ``microbatches`` 0 takes the
    reference's plan (``_auto_lm_train_plan`` on one device: one sequence
    a microbatch, the cross-entropy unchunked). Over several microbatches
    each one's gradient is rounded to bf16 before the float32 sum (the
    reference's bf16 gradient reduction, whatever the params' dtype), and
    loss and gradient are divided by their number."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    mode = "fsdp"
    if microbatches <= 0:
        microbatches, mode = _auto_lm_train_plan(spec.model, B, S, 1, 1, 1)
    chunk = S if mode == "fsdp_seq" else min(1024, S)
    n_mb = microbatches
    opt = _opt()

    def loss_fn(p, mb_batch):
        return T.lm_loss(p, cfg, recall, mb_batch["tokens"],
                         mb_batch["labels"], remat=remat, chunk=chunk,
                         window=window)[0]

    def train_step(params, opt_state, batch):
        if n_mb == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            mb_size = B // n_mb
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
            for i in range(n_mb):
                mb = {k: v[i * mb_size:(i + 1) * mb_size]
                      for k, v in batch.items()}
                li, gi = value_and_grad(loss_fn, params, mb)
                loss = loss + li.float()
                grads = _map(lambda a, g: a.add_(g.to(torch.bfloat16)),
                             grads, gi)
                del gi
            loss = loss / n_mb
            grads = _map(lambda g: g.div_(n_mb), grads)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **metrics}

    tokens = B * S
    return StepBundle(
        name="train_step", fn=train_step,
        model_flops=6.0 * cfg.n_active_params * tokens,
        meta={"tokens": tokens, "cfg": cfg, "train": True, "remat": remat,
              "microbatches": microbatches, "mode": mode, "chunk": chunk,
              "device": dev, "inputs": {k: ((B, S), torch.int32)
                                        for k in ("tokens", "labels")}})


def build_lm_prefill(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                     window: int = 0, n_layers: Optional[int] = None,
                     pad_to: Optional[int] = None) -> StepBundle:
    """fn(params, tokens (B, S)) -> {k_cache, v_cache (L, B, max(S,
    pad_to), KV, hd), exit_embs (n_exits, B, E)}."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len

    def prefill_step(params, tokens):
        out = T.prefill(params, cfg, recall, tokens, pad_to=pad_to,
                        window=window)
        return {"k_cache": out["k_cache"], "v_cache": out["v_cache"],
                "exit_embs": out["exit_embs"]}

    tokens = B * S
    return StepBundle(
        name="prefill_step", fn=prefill_step,
        model_flops=2.0 * cfg.n_active_params * tokens,
        meta={"tokens": tokens, "cfg": cfg, "device": dev})


def build_lm_decode(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                    window: int = 0,
                    n_layers: Optional[int] = None) -> StepBundle:
    """fn(params, token (B,), k_cache, v_cache (L, B, S, KV, hd), lengths
    (B,) int32 incl. the new token) -> (logits (B, V) f32, k_cache,
    v_cache), the caches written in place."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len

    def decode_step(params, token, k_cache, v_cache, lengths):
        return T.decode_step(params, cfg, recall, token, k_cache, v_cache,
                             lengths, window=window)

    return StepBundle(
        name="serve_step", fn=decode_step,
        model_flops=2.0 * cfg.n_active_params * B
        + 2.0 * 2 * B * S * cfg.n_heads * cfg.head_dim,  # + KV attention read
        meta={"tokens": B, "cfg": cfg, "device": dev})


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def build_mem_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                   n_layers: Optional[int] = None,
                   remat: bool = True) -> StepBundle:
    """The MEM family's steps by ``shape.kind``:
      * ``serve``: fn(params, x (B, T, d_in)) -> (n_exits, B, E), the
        vision tower's embedding at every exit;
      * ``train``: fn(params, opt_state, batch) -> (params, opt_state,
        {"loss", "grad_norm", "lr"}), the contrastive loss binding every
        modality in ``batch`` to vision, each tower under ``remat``;
      * ``retrieval``: fn(params, q_tokens (B, T), bank (C, E)) -> (top-10
        similarities, indices) of the text embeddings against ``bank``."""
    cfg: MEMConfig = spec.model
    if n_layers is not None:
        cfg = replace(cfg, towers=tuple(
            replace(t, n_layers=min(n_layers, t.n_layers))
            for t in cfg.towers))
    recall = spec.recall
    dev = resolve_device(device)
    B = shape.global_batch
    meta = {"cfg": cfg, "device": dev}

    if shape.kind == "serve":
        t = cfg.tower("vision")

        def embed_step(params, x):
            return IB.mem_embed_all_exits(params, cfg, recall, "vision",
                                          x)["exit_embs"]

        flops = 2.0 * 12 * t.d_model ** 2 * t.n_layers * (t.n_tokens + 1) * B
        return StepBundle("serve_step", embed_step, flops, meta)

    if shape.kind == "train":
        opt = _opt()

        def loss_fn(p, batch):
            return IB.mem_contrastive_loss(p, cfg, recall, batch,
                                           remat=remat)[0]

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state, m = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, **m}

        flops = 3.0 * sum(2 * 12 * t.d_model ** 2 * t.n_layers
                          * (t.n_tokens + 1) for t in cfg.towers) * B
        inputs = {t.modality: (((B, t.n_tokens), torch.int32)
                               if t.modality == "text" else
                               ((B, t.n_tokens, t.d_input),
                                torch_dtype(cfg.dtype)))
                  for t in cfg.towers}
        return StepBundle("train_step", train_step, flops,
                          {**meta, "train": True, "remat": remat,
                           "items": B, "inputs": inputs})

    if shape.kind == "retrieval":
        t = cfg.tower("text")
        C = shape.n_candidates

        def query_step(params, q_tokens, bank):
            z = IB.mem_embed(params, cfg, recall, "text", q_tokens)
            return _top_k(z.float() @ bank.float().T, 10)

        flops = (2 * 12 * t.d_model ** 2 * t.n_layers * (t.n_tokens + 1) * B
                 + 2.0 * B * C * cfg.embed_dim)
        return StepBundle("serve_step", query_step, flops, meta)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN steps
# ---------------------------------------------------------------------------


def build_gnn_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                   n_layers: Optional[int] = None) -> StepBundle:
    """The gnn family's train step, fn(params, opt_state, g: ``gnn.Graph``)
    -> (params, opt_state, {"loss", "grad_norm", "lr"}), params from
    ``gnn.gnn_init(..., cfg=meta["cfg"], embed_out=meta["embed_out"])``:
      * ``graph_full``: one graph of the shape's nodes and edges, each
        round under remat;
      * ``graph_mini``: a sampled subgraph padded to ``max_sizes`` of the
        shape's seeds and fanout (``data.sampler.sample_subgraph``), remat;
      * ``graph_batched``: ``global_batch`` graphs, each field with a
        leading graph axis (``gnn_loss_batched``, no remat)."""
    cfg: GNNConfig = replace(spec.model,
                             d_feat=shape.d_feat or spec.model.d_feat)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    opt = _opt()
    if shape.kind == "graph_batched":  # molecule: batched small graphs
        Bg, N, E = shape.global_batch, shape.n_nodes, shape.n_edges
        lead, loss_fn = (Bg,), lambda p, g: G.gnn_loss_batched(
            p, cfg, recall, g)[0]
        n_edges_total, n_nodes_total = Bg * E, Bg * N
    elif shape.kind in ("graph_full", "graph_mini"):
        if shape.kind == "graph_mini":
            N, E = max_sizes(shape.batch_nodes, shape.fanout)
        else:
            N, E = shape.n_nodes, shape.n_edges
        lead, loss_fn = (), lambda p, g: G.gnn_loss(p, cfg, recall, g,
                                                    remat=True)[0]
        n_edges_total, n_nodes_total = E, N
    else:
        raise ValueError(shape.kind)
    inputs = {"node_feat": (lead + (N, cfg.d_feat), torch.float32),
              "src": (lead + (E,), torch.int32),
              "dst": (lead + (E,), torch.int32),
              "node_mask": (lead + (N,), torch.float32),
              "edge_mask": (lead + (E,), torch.float32),
              "labels": (lead + (N,), torch.int32)}

    def train_step(params, opt_state, g):
        loss, grads = value_and_grad(loss_fn, params, G.Graph(*g))
        params, opt_state, m = opt.update(grads, opt_state, params,
                                          donate=True)
        return params, opt_state, {"loss": loss, **m}

    # message passing "useful" FLOPs: 5 dense matmuls per node + gather/
    # scatter per edge, x2 (MAC) x3 (fwd+bwd)
    d = cfg.d_hidden
    node_flops = 5 * 2 * d * d * n_nodes_total
    edge_flops = 2 * 6 * d * n_edges_total
    return StepBundle(
        name="train_step", fn=train_step,
        model_flops=3.0 * cfg.n_layers * (node_flops + edge_flops),
        meta={"cfg": cfg, "device": dev, "train": True,
              "embed_out": min(1024, cfg.d_hidden * 8), "n_nodes": N,
              "n_edges": n_edges_total, "inputs": inputs})


# ---------------------------------------------------------------------------
# RecSys steps
# ---------------------------------------------------------------------------


def _recsys_inputs(cfg: RecsysConfig, B: int) -> Dict[str, Tuple]:
    """Each input's (shape, dtype): the reference's
    ``_recsys_abstract_inputs``."""
    i32, f32 = torch.int32, torch.float32
    if cfg.kind == "dlrm":
        return {"dense": ((B, cfg.n_dense), f32),
                "sparse": ((B, len(cfg.table_vocabs)), i32),
                "label": ((B,), f32)}
    if cfg.kind == "bst":
        return {"hist": ((B, cfg.seq_len), i32), "target": ((B,), i32),
                "other": ((B, R.BST_OTHER_DIM), f32), "label": ((B,), f32)}
    if cfg.kind == "sasrec":
        return {"hist": ((B, cfg.seq_len), i32),
                "pos": ((B, cfg.seq_len), i32),
                "neg": ((B, cfg.seq_len), i32), "target": ((B,), i32)}
    if cfg.kind == "dien":
        return {"hist": ((B, cfg.seq_len), i32),
                "hist_cate": ((B, cfg.seq_len), i32),
                "target": ((B,), i32), "target_cate": ((B,), i32),
                "label": ((B,), f32)}
    raise ValueError(cfg.kind)


def _recsys_flops(cfg: RecsysConfig, B: int) -> float:
    D = cfg.embed_dim
    if cfg.kind == "dlrm":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        f = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        n_f = len(cfg.table_vocabs) + 1
        f += 2 * n_f * n_f * D
        tdims = (cfg.bot_mlp[-1] + n_f * (n_f - 1) // 2,) + cfg.top_mlp
        f += sum(2 * a * b for a, b in zip(tdims[:-1], tdims[1:]))
        return float(f * B)
    if cfg.kind in ("bst", "sasrec"):
        S = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
        per_block = 2 * S * 4 * D * D + 4 * S * S * D + 2 * S * 2 * D * (4 * D)
        f = cfg.n_blocks * per_block
        if cfg.kind == "bst":
            dims = (S * D + R.BST_OTHER_DIM,) + cfg.mlp + (1,)
            f += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return float(f * B)
    if cfg.kind == "dien":
        H, S = cfg.gru_dim, cfg.seq_len
        gru = 2 * S * 3 * (2 * D * H + H * H) * 2  # two GRU passes
        dims = (H + 2 * D,) + cfg.mlp + (1,)
        mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return float((gru + mlp) * B)
    raise ValueError(cfg.kind)


def build_recsys_step(spec: ArchSpec, shape: ShapeConfig, *,
                      device="cuda") -> StepBundle:
    """The recsys family's steps by ``shape.kind``, params from
    ``recsys.recsys_init``, ``batch`` a dict of the tensors named in
    ``meta["inputs"]``:
      * ``train``: fn(params, opt_state, batch) -> (params, opt_state,
        {"loss", "grad_norm", "lr"});
      * ``serve``: fn(params, batch) -> (B,) sigmoid of the logit;
      * ``retrieval``: fn(params, batch with ``cand_bank`` (C, D)) -> (top
        100 scores, their candidate ids) of each query, ties to the lower
        id (``lax.top_k``'s order)."""
    cfg: RecsysConfig = spec.model
    dev = resolve_device(device)
    B = shape.global_batch
    inputs = _recsys_inputs(cfg, max(B, 1))
    meta = {"cfg": cfg, "device": dev, "items": B, "inputs": inputs}

    if shape.kind == "train":
        opt = _opt()

        def loss_fn(p, batch):
            return R.recsys_loss(p, cfg, batch)[0]

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(loss_fn, params, batch)
            params, opt_state, m = opt.update(grads, opt_state, params,
                                              donate=True)
            return params, opt_state, {"loss": loss, **m}

        return StepBundle("train_step", train_step,
                          3.0 * _recsys_flops(cfg, B),
                          {**meta, "train": True})

    if shape.kind == "serve":
        def serve_step(params, batch):
            return torch.sigmoid(R.recsys_forward(params, cfg, batch))

        return StepBundle("serve_step", serve_step, _recsys_flops(cfg, B),
                          meta)

    if shape.kind == "retrieval":
        C = shape.n_candidates
        D = cfg.bot_mlp[-1] if cfg.kind == "dlrm" else cfg.embed_dim
        inputs["cand_bank"] = ((C, D), torch.float32)

        def retrieval_step(params, batch):
            return _top_k(R.retrieval_scores(params, cfg, batch, C), 100)

        return StepBundle(
            "serve_step", retrieval_step,
            _recsys_flops(cfg, B) + 2.0 * B * C * cfg.embed_dim, meta)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def build_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
               window: int = 0, n_layers: Optional[int] = None,
               pad_to: Optional[int] = None, **train_kw) -> StepBundle:
    """The bundle of ``spec``'s ``shape`` cell; ``train_kw`` (``remat``,
    and for the LM ``microbatches``) goes to the LM and MEM train
    builders."""
    if spec.family == "mem":
        return build_mem_step(spec, shape, device=device, n_layers=n_layers,
                              **train_kw)
    if spec.family == "gnn":
        return build_gnn_step(spec, shape, device=device, n_layers=n_layers)
    if spec.family == "recsys":
        return build_recsys_step(spec, shape, device=device)
    if spec.family != "lm":
        raise ValueError(spec.family)
    if shape.kind == "train":
        return build_lm_train(spec, shape, device=device, window=window,
                              n_layers=n_layers, **train_kw)
    if shape.kind == "prefill":
        return build_lm_prefill(spec, shape, device=device, window=window,
                                n_layers=n_layers, pad_to=pad_to)
    if shape.kind == "decode":
        return build_lm_decode(spec, shape, device=device, window=window,
                               n_layers=n_layers)
    raise ValueError(shape.kind)


def lm_decode_hbm_bytes(cfg: LMConfig, B: int, S: int, n_dev: int) -> float:
    """Decode roofline = read every active weight + the whole KV cache once
    (the reference's closed form)."""
    dt = 2.0
    weights = cfg.n_active_params * dt / n_dev
    kv = 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * dt / n_dev
    return weights + kv + 2.0 * B * cfg.vocab * 4.0 / n_dev
