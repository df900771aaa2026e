"""Inputs made from ``--seed`` on the device.

``multimodal_pairs`` is the generator of the port's
``data/synthetic.multimodal_pairs`` with its distributions, drawn by
torch generators on the device instead of numpy on the host (the photo
pool is half a gigabyte): one latent z (16-d) per item; each modality
observes a fixed random projection of z (the "world", from
``world_seed``, the same for every seed); photos add noise whose scale
grows linearly with the item's ``difficulty`` (higher needs a deeper
exit), captions are the argmax over the vocabulary of a low-noise
projection.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

ARGMAX_ROWS = 16


def multimodal_pairs(seed: int, n: int, towers: Sequence[Dict], device, *,
                     d_latent: int = 16, noise_lo: float = 0.05,
                     noise_hi: float = 1.2, world_seed: int = 1234
                     ) -> Dict[str, torch.Tensor]:
    """{modality: (n, T, d_in) float32 features or (n, T) int64 tokens,
    "difficulty": (n,)} for the ``towers`` given (dicts with ``modality``,
    ``n_tokens``, ``d_input`` and, for text, ``vocab``). As in the port's
    generator, a caption projects through the text tower's ``d_input``,
    which is 0 (taken as 1): every token of every caption is one of
    the same two ids."""
    world = torch.Generator(device=device).manual_seed(world_seed)
    rng = torch.Generator(device=device).manual_seed(int(seed) + 1)
    z = torch.randn(n, d_latent, generator=rng, device=device)
    difficulty = torch.rand(n, generator=rng, device=device)
    noise = noise_lo + (noise_hi - noise_lo) * difficulty
    out: Dict[str, torch.Tensor] = {"difficulty": difficulty}
    for t in towers:
        T, d_in = t["n_tokens"], t["d_input"] or 1
        W = torch.randn(d_latent, T * d_in, generator=world, device=device)
        obs = (z @ W).view(n, T, d_in)
        if t.get("vocab"):
            obs = obs + 0.1 * torch.randn(obs.shape, generator=rng,
                                          device=device)
            Wv = torch.randn(d_in, t["vocab"], generator=world,
                             device=device)
            out[t["modality"]] = torch.cat(
                [torch.argmax(obs[i:i + ARGMAX_ROWS] @ Wv, dim=-1)
                 for i in range(0, n, ARGMAX_ROWS)])
        else:
            obs += noise[:, None, None] * torch.randn(
                obs.shape, generator=rng, device=device)
            out[t["modality"]] = obs
    return out


def token_batches(seed: int, n_batches: int, batch: int, seq: int,
                  vocab: int, device) -> torch.Tensor:
    """(n_batches, batch, seq) int64 prompt ids, uniform over the
    vocabulary: every row differs, and a dense model's work does not
    depend on the ids."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, vocab, (n_batches, batch, seq), generator=g,
                         device=device)
