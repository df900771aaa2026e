"""Roofline terms of a step on the H100.

The counterpart of the reference's ``launch/hlo_analysis.py`` with its
constants the card's (``launch.mesh``): ``Roofline``, ``linear_fit_two``
and ``flash_loop_correction``, the same arithmetic. The reference's
collective parse (``parse_collectives``, ``_shape_bytes``,
``CollectiveStats``) reads the HLO text of XLA's SPMD partitioner, which
nothing in the port emits, so it has no counterpart here; the dry run
(``launch.dryrun``) counts no wire bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_LINK, NVLINK_LINKS,
                                     PEAK_FLOPS_BF16)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float      # analytic ideal-fusion model (steps.py)
    wire_bytes_per_device: float
    n_devices: int
    model_flops_total: float
    hbm_bytes_upper: float = 0.0     # unfused upper bound (none in the port)
    ici_links: int = NVLINK_LINKS    # the card's NVLink links (the
    #                                  reference's field name)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def memory_s_upper(self) -> float:
        return self.hbm_bytes_upper / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_device / (NVLINK_BW_PER_LINK
                                             * self.ici_links)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * PEAK_FLOPS_BF16 * self.n_devices
        return self.model_flops_total / denom if denom else 0.0

    def as_dict(self):
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "hbm_bytes_upper": self.hbm_bytes_upper,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_upper_unfused": self.memory_s_upper,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_s": self.step_s, "model_flops_total": self.model_flops_total,
            "useful_ratio": self.useful_ratio, "mfu_at_roofline": self.mfu,
        }


def linear_fit_two(l1: float, v1: float, l2: float, v2: float, L: float
                   ) -> float:
    """Fit v = fixed + L*per_layer through (l1,v1),(l2,v2); eval at L."""
    per_layer = (v2 - v1) / (l2 - l1)
    fixed = v1 - per_layer * l1
    return fixed + per_layer * L


def flash_loop_correction(*, B: int, KV: int, G: int, D: int, Sq: int,
                          Skv: int, bq: int, bkv: int, train: bool,
                          remat: bool, causal_skip: bool = False,
                          dtype_bytes: int = 2) -> Tuple[float, float]:
    """FLOPs (and approximate bytes) of the flash-attention block-loop
    bodies that a program counting each loop body once misses, PER LAYER,
    GLOBAL (divide by n_devices): nq*nkv bodies run forward (twice under
    train with remat) and nq*nkv backward, one of each counted; with
    ``causal_skip`` only the live lower-triangle blocks run (~half)."""
    nq, nkv = -(-Sq // bq), -(-Skv // bkv)
    pairs = nq * nkv
    if causal_skip:
        pairs = (nq * (nkv + 1)) // 2 if Sq == Skv else pairs
    miss_fwd = (pairs - 1) * (2 if (train and remat) else 1)
    miss_bwd = (pairs - 1) if train else 0
    heads = B * KV * G
    f_fwd_body = 4.0 * heads * bq * bkv * D + 8.0 * heads * bq * bkv
    f_bwd_body = 10.0 * heads * bq * bkv * D + 12.0 * heads * bq * bkv
    flops = miss_fwd * f_fwd_body + miss_bwd * f_bwd_body
    b_body = dtype_bytes * (heads * bq * D + 2 * B * KV * bkv * D) \
        + 8.0 * heads * bq * D  # f32 acc read+write
    bytes_ = (miss_fwd + miss_bwd) * b_body
    return flops, bytes_
