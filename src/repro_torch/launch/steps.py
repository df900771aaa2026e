"""Step builders: one function per (arch x shape) cell, the counterpart
of the reference's ``launch/steps.py`` without mesh or shardings (one
device).

``build_step(spec, shape)`` returns a :class:`StepBundle` with the step
function, the analytic model FLOPs (the reference's convention) and meta
(the config the step runs, its device and token count). The caller makes
the parameters (``transformer.lm_init`` / ``imagebind.mem_init`` on
``meta["device"]``), the optimizer state (``AdamW.init``) and inputs.
Ported: the ``lm`` family's ``train``, ``prefill`` and ``decode`` kinds
and every kind of the ``mem`` family (``serve``, ``train``,
``retrieval``). A train step is ``fn(params, opt_state, batch) ->
(params, opt_state, {"loss", "grad_norm", "lr"})`` with the reference's
optimizer (``_opt``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec, LMConfig, MEMConfig, ShapeConfig
from repro_torch.models import imagebind as IB
from repro_torch.models import transformer as T
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
              "device": dev})


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
        return StepBundle("train_step", train_step, flops,
                          {**meta, "train": True, "remat": remat,
                           "items": B})

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


def build_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
               window: int = 0, n_layers: Optional[int] = None,
               pad_to: Optional[int] = None, **train_kw) -> StepBundle:
    """The bundle of ``spec``'s ``shape`` cell; ``train_kw`` (``remat``,
    and for the LM ``microbatches``) goes to the train builders."""
    if spec.family == "mem":
        return build_mem_step(spec, shape, device=device, n_layers=n_layers,
                              **train_kw)
    if spec.family != "lm":
        raise NotImplementedError(
            f"steps for the {spec.family!r} family are not ported yet: "
            "ROADMAP queue A.6")
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
