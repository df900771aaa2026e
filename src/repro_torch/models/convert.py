"""Carry the reference's parameters across to the port.

``params_from_jax`` takes the JAX parameter tree with its leaves already
converted to numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's nested dict of tensors. Leaves keep the reference's
layout, stacked ``(L, ...)`` layer leaves included (``wq (L, d, H, hd)``,
``wo (L, H, hd, d)``), so the port's modules read them unchanged. The same
function carries the pre-exit predictor's MLP across.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a)).to(device)
    # bfloat16 numpy arrays (ml_dtypes) go through fp32 exactly
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    own = torch.bfloat16 if a.dtype.name == "bfloat16" else torch_dtype(
        a.dtype.name)
    return t.to(device=device, dtype=dtype or own)


def params_from_jax(np_tree: Any, device="cpu", dtype=None) -> Any:
    """numpy leaves of a JAX param tree -> tensors on ``device``; ``dtype``
    (None = each leaf's own) casts every float leaf."""
    device = torch.device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    if isinstance(np_tree, Mapping):
        return {k: params_from_jax(v, device, dt) for k, v in np_tree.items()}
    return _leaf(np_tree, device, dt)
