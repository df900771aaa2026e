"""Config dataclasses and registry for the port (the ``mem`` family only).

A copy of the parts of ``repro.configs.base`` that RECALL's serving path
reads, so the port imports nothing of the JAX package. Field names and
defaults are the reference's; ``tests/test_torch_imports.py`` keeps the
port free of ``repro`` imports and the parity tests keep the values equal.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class LMConfig:
    """Transformer stack config; the MEM towers use it bidirectionally."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: int = 0  # 0 = full attention; >0 = sliding window
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads


@dataclass(frozen=True)
class TowerConfig:
    """One MEM modality tower (transformer encoder on stub frontend tokens)."""

    modality: str  # "vision" | "text" | "audio" | "imu"
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_tokens: int  # sequence length after the (stub) frontend
    d_input: int  # frontend feature dim (patch/frame/token-embedding dim)
    vocab: int = 0  # text only


@dataclass(frozen=True)
class MEMConfig:
    """ImageBind-style multimodal embedding model."""

    towers: Tuple[TowerConfig, ...]
    embed_dim: int = 1024
    logit_scale_init: float = 14.285  # 1/0.07, CLIP default
    norm_eps: float = 1e-6
    dtype: str = "float32"

    def tower(self, modality: str) -> TowerConfig:
        for t in self.towers:
            if t.modality == modality:
                return t
        raise KeyError(modality)


@dataclass(frozen=True)
class RecallConfig:
    """Knobs for the paper's technique."""

    enabled: bool = True
    exit_interval: int = 4           # exit tap every k layers
    superficial_layers: int = 7      # N in the paper (pre-exit reads layer-N state)
    predictor_hidden: int = 256      # pre-exit MLP hidden width
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    plora_min_step: int = 1
    plora_max_step: int = 4
    filter_top_k: int = 10           # speculative filter width per granularity
    query_granularities: int = 3     # how many exit depths to embed the query at
    cache_bits: int = 4              # activation cache quantization
    pool: str = "mean"               # how hidden states are pooled into embeddings

    def exit_layers(self, n_layers: int) -> Tuple[int, ...]:
        """1-indexed exit depths (always includes the final layer)."""
        if not self.enabled:
            return (n_layers,)
        exits = list(range(self.exit_interval, n_layers, self.exit_interval))
        if not exits or exits[-1] != n_layers:
            exits.append(n_layers)
        return tuple(exits)


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: names the step and its global dims."""

    name: str
    kind: str  # serve | retrieval | train | ...
    global_batch: int = 0
    seq_len: int = 0
    n_candidates: int = 0
    skip_reason: str = ""


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "mem" is the only family the port carries
    model: Any  # MEMConfig
    shapes: Tuple[ShapeConfig, ...]
    recall: RecallConfig = RecallConfig()
    source: str = ""
    notes: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}

_ARCH_MODULES = ["recall_imagebind"]


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def _ensure_loaded() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    key = arch_id.replace("_", "-")
    if key in _REGISTRY:
        return _REGISTRY[key]
    if arch_id in _REGISTRY:
        return _REGISTRY[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")


def smoke_variant(spec: ArchSpec) -> ArchSpec:
    """Shrink a full ``mem`` config to a CPU-runnable one of the same family
    (the reference's ``mem`` branch, value for value)."""
    if spec.family != "mem":
        raise ValueError(f"the port carries only the mem family, not "
                         f"{spec.family!r}")
    m = spec.model
    towers = tuple(
        replace(t, n_layers=3, d_model=32, n_heads=2, d_ff=64,
                n_tokens=min(t.n_tokens, 16), d_input=min(t.d_input, 24),
                vocab=min(t.vocab, 256) if t.vocab else 0)
        for t in m.towers
    )
    sm = replace(m, towers=towers, embed_dim=32)
    shapes = (ShapeConfig("smoke_embed", "serve", global_batch=8),)
    rc = replace(spec.recall, exit_interval=1, superficial_layers=1)
    return replace(spec, arch_id=spec.arch_id + "-smoke", model=sm,
                   shapes=shapes, recall=rc)
