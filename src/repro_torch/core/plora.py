"""Progressive LoRA healing (paper §3.3): the shared LoRA suite and its
progressive windows.

One *shared* LoRA suite serves every exit: the LoRA of layers [0, e) is
exactly the prefix of the suite used by exit e + 1, so layer-n activations
are reusable when continuing to layer n + 1 (the property §3.4's cached
refinement depends on). Exits are healed in increasing order; at each phase
only the LoRA of layers inside the current *step window* receives
gradients, and the step size grows for deeper exits by the pivot rule
driven by the predicted-exit histogram.

LoRA params are nested dicts ``{target: {"a": (L, ...), "b": (L, ...)}}``
stacked over layers like the model's, the reference's layout, so
``models/convert.params_from_jax`` carries a JAX LoRA tree across.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, RecallConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema


def lora_schema(cfg: LMConfig, recall: RecallConfig) -> Schema:
    """Stacked (n_layers leading dim) LoRA params for the configured
    targets. B ("b") matrices start at zero => identity behaviour at init."""
    Ld = (cfg.n_layers,)
    la = ("layer",)
    r = recall.lora_rank
    d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    defs = {
        "wq": (ParamDef(Ld + (d, r), la + ("embed", None), "fan_in"),
               ParamDef(Ld + (r, H, hd), la + (None, "heads", "head_dim"), "zeros")),
        "wk": (ParamDef(Ld + (d, r), la + ("embed", None), "fan_in"),
               ParamDef(Ld + (r, KV, hd), la + (None, "kv_heads", "head_dim"), "zeros")),
        "wv": (ParamDef(Ld + (d, r), la + ("embed", None), "fan_in"),
               ParamDef(Ld + (r, KV, hd), la + (None, "kv_heads", "head_dim"), "zeros")),
        "wo": (ParamDef(Ld + (H, hd, r), la + ("heads", "head_dim", None), "fan_in"),
               ParamDef(Ld + (r, d), la + (None, "embed"), "zeros")),
    }
    if cfg.moe is None and f:
        defs.update({
            "w_gate": (ParamDef(Ld + (d, r), la + ("embed", None), "fan_in"),
                       ParamDef(Ld + (r, f), la + (None, "mlp"), "zeros")),
            "w_up": (ParamDef(Ld + (d, r), la + ("embed", None), "fan_in"),
                     ParamDef(Ld + (r, f), la + (None, "mlp"), "zeros")),
            "w_down": (ParamDef(Ld + (f, r), la + ("mlp", None), "fan_in"),
                       ParamDef(Ld + (r, d), la + (None, "embed"), "zeros")),
        })
    return {t: {"a": a, "b": b} for t, (a, b) in defs.items()
            if t in recall.lora_targets}


def lora_init(gen: torch.Generator, cfg: LMConfig, recall: RecallConfig,
              dtype=torch.float32, device="cuda"):
    """Random LoRA params from ``gen`` (a generator on ``device``)."""
    return L.init_params(gen, lora_schema(cfg, recall), dtype=dtype,
                         device=device)


def lora_specs(cfg: LMConfig, recall: RecallConfig):
    return L.param_specs(lora_schema(cfg, recall))


def lora_n_params(cfg: LMConfig, recall: RecallConfig) -> int:
    return sum(int(np.prod(d.shape)) for pair in lora_schema(cfg, recall).values()
               for d in pair.values())


# ---------------------------------------------------------------------------
# Progressive window machinery
# ---------------------------------------------------------------------------


def window_mask(lora, lo: int, hi: int):
    """0/1 float32 mask tree: 1 for layers in [lo, hi), shaped (L, 1, ...)
    to broadcast over each leaf; only those layers receive grads."""
    if isinstance(lora, torch.Tensor):
        idx = torch.arange(lora.shape[0], device=lora.device)
        m = ((idx >= lo) & (idx < hi)).to(torch.float32)
        return m.reshape((-1,) + (1,) * (lora.dim() - 1))
    return {k: window_mask(v, lo, hi) for k, v in lora.items()}


def plora_phases(exits: Sequence[int],
                 steps: Sequence[int]) -> List[Tuple[int, int]]:
    """Per healing phase: (layer_lo, layer_hi) windows that tile [0, L).
    ``steps[i]`` = how many exits are healed jointly in phase i."""
    phases = []
    i = 0
    prev_layer = 0
    while i < len(exits):
        step = steps[min(len(phases), len(steps) - 1)]
        j = min(i + step, len(exits))
        phases.append((prev_layer, exits[j - 1]))
        prev_layer = exits[j - 1]
        i = j
    return phases


def schedule_steps(exit_hist: np.ndarray, recall: RecallConfig) -> List[int]:
    """P-LoRA step decision (paper §3.3): the pivot at the histogram's mass
    centre; exits at or before it heal with the min step, later exits with
    steps growing by one an exit up to the max step."""
    h = np.asarray(exit_hist, np.float64)
    n = len(h)
    if h.sum() <= 0:
        pivot = 0
    else:
        cum = np.cumsum(h) / h.sum()
        pivot = int(np.searchsorted(cum, 0.5))
    steps = []
    i = 0
    while i < n:
        if i <= pivot:
            s = recall.plora_min_step
        else:
            s = min(recall.plora_min_step + (i - pivot), recall.plora_max_step)
        steps.append(s)
        i += s
    return steps


def merge_lora(params: Schema, lora, recall: RecallConfig) -> Schema:
    """Fold LoRA deltas into base weights (deployment-time merge).

    The A@B contraction and the W + delta sum run in float64 on the host
    (numpy), as the reference's do, so the merged weights are bit-equal to
    the reference's on the same inputs. Returns a new tree; the inputs are
    not changed."""
    scale = recall.lora_alpha / recall.lora_rank

    def np64(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float64).numpy()

    def merged(w: torch.Tensor, delta: np.ndarray) -> torch.Tensor:
        # float64 -> float32 -> the weight's dtype, the reference's two
        # roundings (its jnp.asarray lands in float32 first)
        out = torch.from_numpy(np64(w) + delta).to(torch.float32)
        return out.to(device=w.device, dtype=w.dtype)

    attn = dict(params["layers"]["attn"])
    mlp = dict(params["layers"].get("mlp", {}))
    for t, ab in lora.items():
        a, b = np64(ab["a"]), np64(ab["b"])
        if t in ("wq", "wk", "wv"):
            attn[t] = merged(attn[t], np.einsum("ldr,lrhk->ldhk", a, b) * scale)
        elif t == "wo":
            attn[t] = merged(attn[t], np.einsum("lhkr,lrd->lhkd", a, b) * scale)
        elif t in ("w_gate", "w_up", "w_down"):
            mlp[t] = merged(mlp[t], np.einsum("ldr,lrf->ldf", a, b) * scale)
    layers = dict(params["layers"], attn=attn)
    if mlp:
        layers["mlp"] = mlp
    return dict(params, layers=layers)
