"""Step builders: one function per (arch x shape) cell, the counterpart
of the reference's ``launch/steps.py``. The step function runs on one
device.

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

``build_step(..., mesh=...)`` adds the layout the step takes on that mesh
(``distributed.mesh_utils``): ``meta["rules"]``, the rules table the
reference picks for the family and kind; ``meta["in_shardings"]``, one
``NamedSharding`` tree an argument (the params, the optimizer state with
ZeRO's data axis added, the batch, cache or graph); ``meta["abstract_args"]``,
the arguments on the ``meta`` device; for an LM train step
``meta["mesh_plan"]``, the reference's plan at the mesh's data and model
widths (the step keeps its one-device plan). A gnn graph is padded to a
multiple of the mesh's entries, as the reference's. The analytic HBM
accounts at the end (``analytic_hbm_bytes_for``) are the reference's
roofline memory term.
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
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.mesh_utils import (Mesh, NamedSharding,
                                                PartitionSpec, tree_map)
from repro_torch.models import attention as A
from repro_torch.models import gnn as G
from repro_torch.models import imagebind as IB
from repro_torch.models import layers as L
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


# ---------------------------------------------------------------------------
# Shardings (with a mesh)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    """An abstract argument: a tensor on ``meta`` (no storage)."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _shard(mesh: Mesh, rules, axes, ab) -> NamedSharding:
    spec = mesh_utils.logical_to_spec(axes, rules)
    spec = mesh_utils._drop_indivisible(spec, tuple(ab.shape), mesh)
    return NamedSharding(mesh, spec)


def _param_bundle(mesh: Mesh, rules, schema_abstract, schema_specs):
    shardings = mesh_utils.make_shardings(schema_specs, mesh, rules,
                                          abstract_tree=schema_abstract)
    return schema_abstract, shardings


def _finer_sharding(mesh: Mesh, sh: NamedSharding, ab) -> NamedSharding:
    """ZeRO-style: add the data axis on the first still-unsharded,
    divisible dim (optimizer state and gradient accumulators shard over
    data even when the weights are TP-only)."""
    if "data" not in mesh.shape:
        return sh
    spec = list(sh.spec) + [None] * (len(ab.shape) - len(sh.spec))
    used = {a for part in spec if part
            for a in ((part,) if isinstance(part, str) else part)}
    if "data" in used:
        return sh
    dp = mesh.shape["data"]
    for i, (dim, part) in enumerate(zip(ab.shape, spec)):
        shard_factor = 1
        if part:
            for a in ((part,) if isinstance(part, str) else part):
                shard_factor *= mesh.shape[a]
        if part is None and dim % dp == 0:
            spec[i] = "data"
            return NamedSharding(mesh, PartitionSpec(*spec))
        if part is not None and dim % (shard_factor * dp) == 0:
            spec[i] = ((part, "data") if isinstance(part, str)
                       else tuple(part) + ("data",))
            return NamedSharding(mesh, PartitionSpec(*spec))
    return sh


def _opt_state_shardings(mesh: Mesh, params_shardings, opt_abstract,
                         params_abstract=None):
    rep = NamedSharding(mesh, PartitionSpec())
    if params_abstract is None:
        return type(opt_abstract)(step=rep, m=params_shardings,
                                  v=params_shardings)
    fine = tree_map(lambda sh, ab: _finer_sharding(mesh, sh, ab),
                    params_shardings, params_abstract)
    return type(opt_abstract)(step=rep, m=fine, v=fine)


def _dp_tp(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(data-parallel width over pod x data, model width); (1, 1) with no
    mesh."""
    if mesh is None:
        return 1, 1
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    return dp, mesh.shape.get("model", 1)


def _rules(spec: ArchSpec, shape: ShapeConfig, mesh: Mesh) -> Dict[str, Any]:
    """The rules table the reference's ``build_step`` picks (its
    ``multi_pod`` is whether the mesh has a ``pod`` axis): long-context
    decode (B <= 8) shards the KV cache over data along the sequence;
    other decode shards it over model along the sequence."""
    multi_pod = "pod" in mesh.shape
    if spec.family == "lm":
        long_ctx = shape.kind == "decode" and shape.global_batch <= 8
        rules = mesh_utils.lm_rules(multi_pod, seq_shard_kv=long_ctx)
        if shape.kind == "decode" and not long_ctx:
            rules["kv_seq"] = "model"
    else:
        rules = mesh_utils.rules_for_family(spec.family, multi_pod)
    return rules


def _batch_shard(mesh: Mesh, rules, ab) -> NamedSharding:
    return _shard(mesh, rules, ("batch",) + (None,) * (ab.dim() - 1), ab)


def _layout(spec: ArchSpec, shape: ShapeConfig, bundle: "StepBundle",
            mesh: Mesh, rules, microbatches: int = 0) -> Dict[str, Any]:
    """{"rules", "in_shardings", "abstract_args"} of a built bundle, the
    reference's leaf for leaf, and for an LM train step "mesh_plan", its
    {"microbatches", "mode", "chunk"} at the mesh's data and model
    widths."""
    meta, fam, kind = bundle.meta, spec.family, shape.kind
    cfg = meta["cfg"]
    recall = spec.recall
    train = bool(meta.get("train"))
    if fam == "lm":
        if kind == "train":
            # the plan of one device's share of the mesh; the step itself
            # keeps its one-device plan
            dp, tp = _dp_tp(mesh)
            mb, mode, chunk = _lm_train_plan(spec.model, shape.global_batch,
                                             shape.seq_len, microbatches,
                                             dp, tp)
            plan = {"mesh_plan": {"microbatches": mb, "mode": mode,
                                  "chunk": chunk}}
            if mode == "fsdp_seq":
                rules = dict(rules, seq="model")  # sequence-sharded acts
        ab_p, p_sh = _param_bundle(mesh, rules, T.lm_abstract(cfg, recall),
                                   T.lm_specs(cfg, recall))
        B, S = shape.global_batch, shape.seq_len
        if kind == "train":
            ab_opt = _opt().init(ab_p)
            o_sh = _opt_state_shardings(mesh, p_sh, ab_opt, params_abstract=ab_p)
            ab_b = {k: _sds(*meta["inputs"][k]) for k in ("tokens", "labels")}
            b_sh = {k: _shard(mesh, rules, ("batch", "seq"), v)
                    for k, v in ab_b.items()}
            return {"rules": rules, "in_shardings": (p_sh, o_sh, b_sh),
                    "abstract_args": (ab_p, ab_opt, ab_b), **plan}
        if kind == "prefill":
            ab_t = _sds((B, S), torch.int32)
            args = (ab_p, ab_t)
            shs = (p_sh, _shard(mesh, rules, ("batch", "seq"), ab_t))
        else:
            ab_c = _sds((cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim),
                        torch_dtype(cfg.dtype))
            c_sh = _shard(mesh, rules, ("layer", "kv_batch", "kv_seq",
                                        "kv_heads", "head_dim"), ab_c)
            rep = mesh_utils.replicated(mesh)
            ab_i = _sds((B,), torch.int32)
            args = (ab_p, ab_i, ab_c, ab_c, _sds((B,), torch.int32))
            shs = (p_sh, rep, c_sh, c_sh, rep)
        return {"rules": rules, "in_shardings": shs, "abstract_args": args}

    if fam == "gnn":
        schema = G.gnn_schema(cfg, recall, embed_out=meta["embed_out"])
        ab_in = G.Graph(**{k: _sds(*v) for k, v in meta["inputs"].items()})
        if kind == "graph_batched":
            in_sh = G.Graph(*[_batch_shard(mesh, rules, a) for a in ab_in])
        else:
            axes = {"node_feat": ("nodes", None), "src": ("edges",),
                    "dst": ("edges",), "node_mask": ("nodes",),
                    "edge_mask": ("edges",), "labels": ("nodes",)}
            in_sh = G.Graph(**{k: _shard(mesh, rules, axes[k], a)
                               for k, a in ab_in._asdict().items()})
        specs = L.param_specs(schema)
    elif fam == "recsys":
        schema = R.recsys_schema(cfg)
        ab_in = {k: _sds(*v) for k, v in meta["inputs"].items()}
        in_sh = {k: _shard(mesh, rules, ("cands", None), v)
                 if k == "cand_bank" else _batch_shard(mesh, rules, v)
                 for k, v in ab_in.items()}
        specs = L.param_specs(schema)
    elif fam == "mem":
        schema = IB.mem_schema(cfg, recall)
        specs = IB.mem_specs(cfg, recall)
        B, dt = shape.global_batch, torch_dtype(cfg.dtype)

        def ab_modal(t):
            if t.modality == "text":
                return _sds((B, t.n_tokens), torch.int32)
            return _sds((B, t.n_tokens, t.d_input), dt)
        if kind == "serve":
            ab_in = ab_modal(cfg.tower("vision"))
            in_sh = _shard(mesh, rules, ("batch", "seq", "act_embed"), ab_in)
        elif kind == "train":
            ab_in = {t.modality: ab_modal(t) for t in cfg.towers}
            in_sh = {k: _batch_shard(mesh, rules, v) for k, v in ab_in.items()}
        else:
            ab_q = ab_modal(cfg.tower("text"))
            ab_bank = _sds((shape.n_candidates, cfg.embed_dim), dt)
            ab_in = (ab_q, ab_bank)
            in_sh = (_shard(mesh, rules, ("batch", "seq"), ab_q),
                     _shard(mesh, rules, ("cands", "act_embed"), ab_bank))
    else:
        raise ValueError(fam)
    ab_p, p_sh = _param_bundle(mesh, rules,
                               L.abstract_params(schema, dtype=cfg.dtype),
                               specs)
    if train:
        ab_opt = _opt().init(ab_p)
        args = (ab_p, ab_opt, ab_in)
        shs = (p_sh, _opt_state_shardings(mesh, p_sh, ab_opt), in_sh)
    elif isinstance(ab_in, tuple) and not isinstance(ab_in, G.Graph):
        args, shs = (ab_p,) + ab_in, (p_sh,) + in_sh
    else:
        args, shs = (ab_p, ab_in), (p_sh, in_sh)
    return {"rules": rules, "in_shardings": shs, "abstract_args": args}


def _lm_cfg(spec: ArchSpec, n_layers: Optional[int]) -> LMConfig:
    """The model's config, cut to its first ``n_layers`` when given (a
    hybrid keeps its KDA layers among them)."""
    m = spec.model
    if n_layers is None:
        return m
    if m.kda is not None:
        return replace(m, n_layers=n_layers, kda_layers=tuple(
            i for i in m.kda_layers if i < n_layers))
    return replace(m, n_layers=n_layers)


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


def _lm_train_plan(cfg: LMConfig, B: int, S: int, microbatches: int,
                   dp: int, tp: int) -> Tuple[int, str, int]:
    """(microbatches, mode, cross-entropy chunk) of an LM train step over
    dp x tp devices: ``microbatches`` 0 takes ``_auto_lm_train_plan``,
    any other count runs "fsdp"."""
    mode = "fsdp"
    if microbatches <= 0:
        microbatches, mode = _auto_lm_train_plan(cfg, B, S, dp, tp, dp * tp)
    return microbatches, mode, S if mode == "fsdp_seq" else min(1024, S)


def build_lm_train(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                   window: int = 0, n_layers: Optional[int] = None,
                   remat: bool = True, microbatches: int = 0) -> StepBundle:
    """fn(params, opt_state, {"tokens", "labels"} (B, S) int) -> (params,
    opt_state, {"loss", "grad_norm", "lr"}). ``microbatches`` 0 takes the
    reference's plan for one device (``_lm_train_plan``: one sequence a
    microbatch, the cross-entropy unchunked). Over several microbatches
    each one's gradient is rounded to bf16 before the float32 sum (the
    reference's bf16 gradient reduction, whatever the params' dtype), and
    loss and gradient are divided by their number."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    microbatches, mode, chunk = _lm_train_plan(spec.model, B, S,
                                               microbatches, 1, 1)
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
    """fn(params, tokens (B, S)) -> {the attention stacks' caches by their
    ``cache_names`` (GQA: k_cache, v_cache (L, B, max(S, pad_to), ...);
    MLA: latent_cache; a hybrid: latent_cache, then KDA's kda_state (n_kda,
    B, H, dk, dv) fp32 and conv_state (n_kda, B, conv_size - 1, 3 H d)),
    exit_embs (n_exits, B, E)}."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    keys = A.cache_names(cfg) + ("exit_embs",)

    def prefill_step(params, tokens):
        out = T.prefill(params, cfg, recall, tokens, pad_to=pad_to,
                        window=window)
        return {k: out[k] for k in keys}

    tokens = B * S
    return StepBundle(
        name="prefill_step", fn=prefill_step,
        model_flops=2.0 * cfg.n_active_params * tokens,
        meta={"tokens": tokens, "cfg": cfg, "device": dev})


def build_lm_decode(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                    window: int = 0,
                    n_layers: Optional[int] = None) -> StepBundle:
    """fn(params, token (B,), *caches, lengths (B,) int32 incl. the new
    token) -> (logits (B, V) f32, *caches), the attention stacks' caches
    (GQA: k_cache, v_cache (L, B, S, KV, hd); MLA: latent_cache (L, B, S,
    kv_lora_rank + rope); a hybrid: latent_cache, kda_state, conv_state)
    updated in place."""
    cfg = _lm_cfg(spec, n_layers)
    recall = spec.recall
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len

    def decode_step(params, token, *caches_and_lengths):
        return T.decode_step(params, cfg, recall, token, *caches_and_lengths,
                             window=window)

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


def _pad_up(x: int, m: int) -> int:
    return int(-(-x // m) * m)


def build_gnn_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
                   n_layers: Optional[int] = None,
                   pad: int = 1) -> StepBundle:
    """The gnn family's train step, fn(params, opt_state, g: ``gnn.Graph``)
    -> (params, opt_state, {"loss", "grad_norm", "lr"}), params from
    ``gnn.gnn_init(..., cfg=meta["cfg"], embed_out=meta["embed_out"])``:
      * ``graph_full``: one graph of the shape's nodes and edges, each
        round under remat;
      * ``graph_mini``: a sampled subgraph padded to ``max_sizes`` of the
        shape's seeds and fanout (``data.sampler.sample_subgraph``), remat;
      * ``graph_batched``: ``global_batch`` graphs, each field with a
        leading graph axis (``gnn_loss_batched``, no remat).
    A single graph's nodes and edges are padded up to multiples of
    ``pad`` (a mesh's entry count, as the reference pads them)."""
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
        N, E = _pad_up(N, pad), _pad_up(E, pad)
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
               mesh: Optional[Mesh] = None, window: int = 0,
               n_layers: Optional[int] = None,
               pad_to: Optional[int] = None, **train_kw) -> StepBundle:
    """The bundle of ``spec``'s ``shape`` cell; ``train_kw`` (``remat``,
    and for the LM ``microbatches``) goes to ``build_lm_train`` and
    ``build_mem_step``. With ``mesh``, ``meta`` also holds ``rules`` (the
    family's table, for two pods where the mesh has a ``pod`` axis),
    ``in_shardings``, ``abstract_args`` and, for an LM train step,
    ``mesh_plan``; the step itself is the one-device step, whatever the
    mesh."""
    fam = spec.family
    if fam not in ("lm", "mem", "gnn", "recsys"):
        raise ValueError(fam)
    if fam == "lm" and shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if fam == "mem":
        bundle = build_mem_step(spec, shape, device=device,
                                n_layers=n_layers, **train_kw)
    elif fam == "gnn":
        bundle = build_gnn_step(
            spec, shape, device=device, n_layers=n_layers,
            pad=1 if mesh is None else mesh_utils.mesh_device_count(mesh))
    elif fam == "recsys":
        bundle = build_recsys_step(spec, shape, device=device)
    elif shape.kind == "train":
        bundle = build_lm_train(spec, shape, device=device, window=window,
                                n_layers=n_layers, **train_kw)
    elif shape.kind == "prefill":
        bundle = build_lm_prefill(spec, shape, device=device, window=window,
                                  n_layers=n_layers, pad_to=pad_to)
    else:
        bundle = build_lm_decode(spec, shape, device=device, window=window,
                                 n_layers=n_layers)
    if mesh is not None:
        bundle.meta.update(_layout(spec, shape, bundle, mesh,
                                   _rules(spec, shape, mesh),
                                   train_kw.get("microbatches", 0)))
    return bundle


# ---------------------------------------------------------------------------
# Analytic HBM traffic (ideal fusion): the roofline memory term, the
# reference's closed forms number for number. They count only irreducible
# HBM traffic: weight reads, optimizer state read and written, layer-boundary
# activations (remat recompute included), the KV cache, embedding-row
# gathers.
# ---------------------------------------------------------------------------


def lm_train_hbm_bytes(cfg: LMConfig, B: int, S: int, n_dev: int, tp: int,
                       dp: int, microbatches: int) -> float:
    P = cfg.n_params
    Pa = cfg.n_active_params
    tok_local = B * S / dp
    dt = 2.0
    weights = 4.0 * Pa * dt / tp              # fwd + remat fwd + 2x bwd reads
    opt = 6.0 * P * 4.0 / n_dev               # m,v r/w + grad read + param r/w
    acts = 12.0 * cfg.n_layers * tok_local * cfg.d_model * dt
    kv_attn = (cfg.n_layers * (B / dp) * (S / 512.0) * S
               * cfg.n_kv_heads * cfg.head_dim * dt * 2 * 3)  # kv reread/blocks
    xent = 3.0 * tok_local * (cfg.vocab / tp) * 4.0
    return weights + opt + acts + kv_attn + xent


def lm_prefill_hbm_bytes(cfg: LMConfig, B: int, S: int, n_dev: int, tp: int,
                         dp: int) -> float:
    Pa = cfg.n_active_params
    tok_local = B * S / dp
    dt = 2.0
    weights = Pa * dt / tp
    acts = 4.0 * cfg.n_layers * tok_local * cfg.d_model * dt
    kv_out = 2.0 * cfg.n_layers * (B * S / n_dev) * cfg.n_kv_heads \
        * cfg.head_dim * dt
    kv_attn = (cfg.n_layers * (B / dp) * (S / 512.0) * S
               * cfg.n_kv_heads * cfg.head_dim * dt * 2)
    return weights + acts + kv_out + kv_attn


def lm_decode_hbm_bytes(cfg: LMConfig, B: int, S: int, n_dev: int) -> float:
    """Decode roofline = read every active weight + the whole KV cache once."""
    dt = 2.0
    weights = cfg.n_active_params * dt / n_dev
    kv = 2.0 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * dt / n_dev
    return weights + kv + 2.0 * B * cfg.vocab * 4.0 / n_dev


def gnn_hbm_bytes(cfg: GNNConfig, n_nodes: int, n_edges: int, n_dev: int,
                  train: bool) -> float:
    d = cfg.d_hidden
    passes = 3.0 if train else 1.0
    per_layer = (6.0 * n_edges * d + 6.0 * n_nodes * d) * 4.0 / n_dev
    return passes * cfg.n_layers * per_layer + n_nodes * cfg.d_feat * 4.0 / n_dev


def recsys_hbm_bytes(cfg: RecsysConfig, B: int, n_dev: int, kind: str,
                     n_candidates: int = 0) -> float:
    D = cfg.embed_dim
    passes = 3.0 if kind == "train" else 1.0
    if cfg.kind == "dlrm":
        rows = B * len(cfg.table_vocabs)
    elif cfg.kind == "dien":
        rows = B * (2 * cfg.seq_len + 2)
    else:
        rows = B * (cfg.seq_len + 1)
    gather = passes * rows * D * 4.0 / n_dev
    dense_p = sum(a * b for a, b in zip(
        ((cfg.n_dense,) + cfg.bot_mlp)[:-1], cfg.bot_mlp)) \
        if cfg.kind == "dlrm" else 0
    mlp = passes * 4.0 * (dense_p + sum(cfg.mlp) * 1000) * 4.0 / max(n_dev, 1)
    cand = n_candidates * D * 4.0 / n_dev if n_candidates else 0.0
    acts = passes * B * max(cfg.seq_len, 1) * D * 4.0 / n_dev * 6.0
    return gather + mlp + cand + acts


def mem_hbm_bytes(cfg: MEMConfig, B: int, n_dev: int, tp: int, kind: str,
                  modalities=None) -> float:
    dt = 2.0
    total = 0.0
    passes = 4.0 if kind == "train" else 1.0
    towers = [t for t in cfg.towers
              if modalities is None or t.modality in modalities]
    for t in towers:
        P_t = 12 * t.d_model ** 2 * t.n_layers
        tok_local = B * (t.n_tokens + 1) / (n_dev / tp)
        total += passes * P_t * dt / tp
        total += (12.0 if kind == "train" else 4.0) * t.n_layers * tok_local \
            * t.d_model * dt
    return total


def analytic_hbm_bytes_for(spec: ArchSpec, shape: ShapeConfig,
                           bundle: StepBundle, mesh: Mesh,
                           n_dev: int) -> float:
    """The ideal-fusion HBM model of a cell's step, per device
    (``bundle`` built with ``mesh``)."""
    dp, tp = _dp_tp(mesh)
    if spec.family == "lm":
        cfg = bundle.meta["cfg"]
        if bundle.name == "train_step":
            return lm_train_hbm_bytes(
                cfg, shape.global_batch, shape.seq_len, n_dev, tp, dp,
                bundle.meta["mesh_plan"]["microbatches"])
        if bundle.name == "prefill_step":
            return lm_prefill_hbm_bytes(cfg, shape.global_batch,
                                        shape.seq_len, n_dev, tp, dp)
        return lm_decode_hbm_bytes(cfg, shape.global_batch, shape.seq_len,
                                   n_dev)
    if spec.family == "gnn":
        # the reference counts node_feat's leading dim: for batched graphs
        # that is the number of graphs
        n_nodes = bundle.meta["inputs"]["node_feat"][0][0]
        return gnn_hbm_bytes(bundle.meta["cfg"], n_nodes,
                             bundle.meta["n_edges"], n_dev, True)
    if spec.family == "recsys":
        return recsys_hbm_bytes(spec.model, shape.global_batch, n_dev,
                                shape.kind, shape.n_candidates)
    if spec.family == "mem":
        mods = None if shape.kind == "train" else (
            ("vision",) if shape.kind == "serve" else ("text",))
        extra = (shape.n_candidates * spec.model.embed_dim * 2.0 / n_dev
                 if shape.kind == "retrieval" else 0.0)
        return mem_hbm_bytes(spec.model, shape.global_batch, n_dev, tp,
                             shape.kind, mods) + extra
    return 0.0
