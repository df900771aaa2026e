"""Progressive LoRA healing loop (paper §3.3).

Distills the frozen full-depth ("fine-grained") embedding into every exit's
coarse embedding through a single shared LoRA suite, tuned progressively:
phase p trains only the LoRA of layers in its step window (earlier layers
frozen by gradient masks), walking from shallow exits to deep ones. The
step schedule comes from the predicted-exit histogram pivot
(:func:`repro_torch.core.plora.schedule_steps`). The exit head stays
untuned (paper §3.3 "Training Details"), so refined and coarse embeddings
share one output space.

Each step is one ``torch.autograd.grad`` of the weighted distillation loss
on the LoRA leaves, then ``AdamW.update(..., grad_mask=window_mask(...))``;
the gradient passes the flash-attention and RMSNorm backward kernels on
CUDA (their plain versions on the CPU). Batches are drawn by
``np.random.default_rng(0)``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig, MEMConfig, RecallConfig
from repro_torch.core import plora
from repro_torch.models import imagebind as IB
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW, _leaves, _map


def cosine_distill_loss(coarse: torch.Tensor,
                        fine: torch.Tensor) -> torch.Tensor:
    """1 - cos(coarse, fine); both (..., E), ``fine`` detached."""
    cos = torch.sum(coarse.float() * fine.detach().float(), dim=-1)
    return torch.mean(1.0 - cos)


@dataclasses.dataclass
class HealConfig:
    lr: float = 1e-3
    steps_per_phase: int = 30
    batch: int = 64
    weight_decay: float = 0.0
    exit_weight_floor: float = 0.1  # min weight for exits with few samples


def exit_weights(exit_hist: np.ndarray, floor: float,
                 device) -> torch.Tensor:
    """(n_exits,) f32 weights from the predicted-exit histogram (priority
    where the mass is), each at least ``floor`` before normalising."""
    w = np.maximum(np.asarray(exit_hist, np.float64), 0)
    w = w / max(w.sum(), 1e-9) + floor
    return torch.tensor(w / w.sum(), dtype=torch.float32, device=device)


def exit_distill_loss(embs: torch.Tensor, targets: torch.Tensor,
                      exit_w: torch.Tensor,
                      phase_mask: torch.Tensor) -> torch.Tensor:
    """The weighted mean over the phase's exits of 1 - mean cos(exit
    embedding, target); embs (n_exits, B, E), targets (B, E)."""
    per_exit = 1.0 - torch.mean(
        torch.sum(embs.float() * targets.float(), dim=-1), dim=-1)
    wts = exit_w * phase_mask
    return torch.sum(per_exit * wts) / torch.clamp_min(torch.sum(wts), 1e-9)


def tower_exit_embs(params, mem_cfg: MEMConfig, recall: RecallConfig,
                    modality: str, x: torch.Tensor, lora) -> torch.Tensor:
    """(n_exits, B, E): one tower pass with ``lora``, every exit through
    the shared exit head."""
    t = mem_cfg.tower(modality)
    out = IB.tower_forward(params, mem_cfg, recall, modality, x, lora=lora)
    idx = [e - 1 for e in recall.exit_layers(t.n_layers)]
    return T.exit_embedding(params["towers"][modality], out["pooled"][idx],
                            mem_cfg.norm_eps)


def lm_exit_embs(params, cfg: LMConfig, recall: RecallConfig,
                 tokens: torch.Tensor, lora) -> torch.Tensor:
    """(n_exits, B, E) of an LM used as an embedder (mean-pooled exits)."""
    out = T.forward_hidden(params, cfg, recall, tokens=tokens, lora=lora,
                           collect_pooled=True)
    idx = [e - 1 for e in recall.exit_layers(cfg.n_layers)]
    return T.exit_embedding(params, out["pooled"][idx], cfg.norm_eps)


def _heal(lora, embs_fn: Callable, data: torch.Tensor,
          targets: torch.Tensor, exits: Sequence[int], recall: RecallConfig,
          exit_hist: Optional[np.ndarray],
          heal_cfg: HealConfig) -> Tuple[dict, List[dict]]:
    """The progressive loop: ``embs_fn(batch, lora)`` -> (n_exits, B, E).
    The log has each phase's window, first and last loss and host seconds
    a step."""
    device = targets.device
    if exit_hist is None:
        exit_hist = np.ones(len(exits))
    phases = plora.plora_phases(exits, plora.schedule_steps(exit_hist,
                                                            recall))
    exit_w = exit_weights(exit_hist, heal_cfg.exit_weight_floor, device)
    opt = AdamW(lr=heal_cfg.lr, weight_decay=heal_cfg.weight_decay,
                clip_norm=1.0)
    state = opt.init(lora)
    rng = np.random.default_rng(0)
    n = data.shape[0]
    log = []
    for p_i, (lo, hi) in enumerate(phases):
        gmask = plora.window_mask(lora, lo, hi)
        pmask = torch.tensor([1.0 if lo < e <= hi else 0.0 for e in exits],
                             dtype=torch.float32, device=device)
        losses = []
        t0 = time.perf_counter()
        for _ in range(heal_cfg.steps_per_phase):
            idx = torch.as_tensor(rng.integers(0, n, size=min(heal_cfg.batch,
                                                              n)),
                                  device=device)
            leaves = _map(lambda p: p.detach().requires_grad_(True), lora)
            loss = exit_distill_loss(embs_fn(data[idx], leaves), targets[idx],
                                     exit_w, pmask)
            grads = torch.autograd.grad(loss, _leaves(leaves))
            it = iter(grads)
            lora, state, _ = opt.update(_map(lambda _: next(it), leaves),
                                        state, leaves, grad_mask=gmask)
            losses.append(float(loss.detach()))
        log.append({"phase": p_i, "window": (lo, hi),
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "step_s": (time.perf_counter() - t0) / len(losses)})
    return lora, log


def heal_tower(gen: torch.Generator, params, mem_cfg: MEMConfig,
               recall: RecallConfig, modality: str, data, *,
               exit_hist: Optional[np.ndarray] = None,
               heal_cfg: HealConfig = HealConfig(),
               device="cuda") -> Tuple[dict, List[dict]]:
    """Heal one MEM tower. ``data``: (N, ...) modality inputs (numpy or a
    tensor); ``params`` and ``gen`` on ``device``. Returns (lora,
    phase_log)."""
    device = resolve_device(device)
    t = mem_cfg.tower(modality)
    tcfg = IB.tower_lm_cfg(t, mem_cfg)
    lora = plora.lora_init(gen, tcfg, recall, device=device)
    data = torch.as_tensor(data).to(device)
    # the frozen zero-shot fine-grained embeddings (paper §3.3): computed
    # once; a moving (LoRA-dependent) target would let the optimizer drift
    # the whole embedding space
    with torch.no_grad():
        targets = IB.mem_embed(params, mem_cfg, recall, modality, data)
    return _heal(lora, lambda x, lp: tower_exit_embs(
        params, mem_cfg, recall, modality, x, lp), data, targets,
        recall.exit_layers(t.n_layers), recall, exit_hist, heal_cfg)


def heal_lm(gen: torch.Generator, params, cfg: LMConfig,
            recall: RecallConfig, tokens, *,
            heal_cfg: HealConfig = HealConfig(),
            exit_hist: Optional[np.ndarray] = None,
            device="cuda") -> Tuple[dict, List[dict]]:
    """Heal an LM used as an embedder: distill the full-depth pooled
    embedding into each exit. ``tokens`` (N, S). A MoE config takes its
    gradient through the grouped GEMM's backward (the expert weights are
    frozen, so only the gradient of the layer's input runs)."""
    device = resolve_device(device)
    lora = plora.lora_init(gen, cfg, recall, device=device)
    tokens = torch.as_tensor(tokens).to(device)
    with torch.no_grad():
        out = T.forward_hidden(params, cfg, recall, tokens=tokens,
                               collect_pooled=True)
        targets = T.exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
        del out
    return _heal(lora, lambda x, lp: lm_exit_embs(params, cfg, recall, x, lp),
                 tokens, targets, recall.exit_layers(cfg.n_layers), recall,
                 exit_hist, heal_cfg)
