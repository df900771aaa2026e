"""Mesh construction and the card's published constants.

``make_production_mesh`` gives the reference's production layouts: one
pod is 16 x 16 = 256 entries (data, model); two pods are 2 x 16 x 16 = 512
(pod, data, model), data parallelism spanning (pod, data). Every entry is
``device`` (the dry run's ``meta``: a layout with no card behind it).
``make_mesh`` builds any other mesh (tests, elastic recovery, the
single-process multi-shard runs).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.mesh_utils import Mesh

# NVIDIA H100 SXM, per card (the data sheet; dense rates, at 700 W)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s on the tensor cores
PEAK_FLOPS_FP32 = 67e12        # FLOP/s outside the tensor cores
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW_PER_LINK = 25e9      # bytes/s a direction, NVLink 4
NVLINK_LINKS = 18


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major; a device may
    repeat). None takes the first prod(shape) visible cards and raises
    ``ValueError`` when fewer are visible."""
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(f"a mesh of {tuple(shape)} needs {n} cards; "
                             f"{have} visible")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of "
                         f"{tuple(shape)}")
    return Mesh(np.array(list(devices), dtype=object).reshape(tuple(shape)),
                tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [device] * math.prod(shape))
