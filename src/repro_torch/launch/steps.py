"""Step builders for the LM serving path: one function per (arch x shape)
cell, the counterpart of the reference's ``launch/steps.py`` without mesh
or shardings (one device).

``build_step(spec, shape)`` returns a :class:`StepBundle` with the step
function, the analytic model FLOPs (the reference's convention) and meta
(the config the step runs, its device and token count). The caller makes
the parameters (``transformer.lm_init`` on ``meta["device"]``) and inputs.
Only the ``lm`` family's ``prefill`` and ``decode`` kinds are ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Any, Callable, Dict, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec, LMConfig, ShapeConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    model_flops: float           # analytic "useful" FLOPs (2ND convention)
    meta: Dict[str, Any]


def _lm_cfg(spec: ArchSpec, n_layers: Optional[int]) -> LMConfig:
    return spec.model if n_layers is None else replace(spec.model,
                                                       n_layers=n_layers)


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


def build_step(spec: ArchSpec, shape: ShapeConfig, *, device="cuda",
               window: int = 0, n_layers: Optional[int] = None,
               pad_to: Optional[int] = None) -> StepBundle:
    if spec.family != "lm":
        raise NotImplementedError(
            f"steps for the {spec.family!r} family are not ported yet: "
            "ROADMAP queue A.6")
    if shape.kind == "train":
        raise NotImplementedError("LM training steps are not ported yet: "
                                  "ROADMAP queue A.4")
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
