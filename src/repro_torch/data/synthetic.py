"""Procedural, *learnable* multimodal pairs (the reference's generator).

One latent z per item; each modality observes a fixed random projection of
z plus modality noise, so items differ in SNR and hence in optimal exit.
The draws are the reference's, number for number: the same seeds give the
same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import MEMConfig

_ARGMAX_ROWS = 16  # items per chunk of the (n, T, vocab) text projection


@dataclasses.dataclass
class MultimodalData:
    """Arrays per modality, aligned by item index; plus difficulty (noise)."""
    items: Dict[str, np.ndarray]
    difficulty: np.ndarray  # (N,) in [0,1]; higher = needs deeper exit
    latent: np.ndarray


def multimodal_pairs(seed: int, n: int, cfg: MEMConfig, d_latent: int = 16,
                     noise_lo: float = 0.05, noise_hi: float = 1.2,
                     world_seed: int = 1234) -> MultimodalData:
    """``world_seed`` fixes the modality observation models (projections) so
    different data splits (seeds) are drawn from the same world."""
    world = np.random.default_rng(world_seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((n, d_latent)).astype(np.float32)
    difficulty = rng.uniform(0, 1, n).astype(np.float32)
    noise_scale = noise_lo + (noise_hi - noise_lo) * difficulty
    items: Dict[str, np.ndarray] = {}
    for t in cfg.towers:
        W = world.standard_normal((d_latent, t.n_tokens, t.d_input or 1)).astype(np.float32)
        obs = np.einsum("nz,ztd->ntd", z, W)
        if t.modality == "text" and t.vocab:
            # discrete text: low-noise "caption" tokenization
            obs = obs + 0.1 * rng.standard_normal(obs.shape).astype(np.float32)
            Wv = world.standard_normal((obs.shape[-1], t.vocab)).astype(np.float32)
            # argmax over the vocab in item chunks: at a 49k vocab the whole
            # (n, T, vocab) product would take gigabytes; each entry is the
            # same product either way
            items[t.modality] = np.concatenate(
                [np.argmax(obs[i:i + _ARGMAX_ROWS] @ Wv, axis=-1)
                 for i in range(0, n, _ARGMAX_ROWS)]).astype(np.int32)
        else:
            obs = obs + noise_scale[:, None, None] * rng.standard_normal(
                obs.shape).astype(np.float32)
            items[t.modality] = obs.astype(np.float32)
    return MultimodalData(items=items, difficulty=difficulty, latent=z)
