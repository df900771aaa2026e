"""Exit-group scheduling + edge-device cost model (paper Algorithm 1,
Table 2).

Two roles:

1. ``ExitGroupPlan``: the scheduler the serving engine uses. Samples are
   grouped by predicted exit so every executed batch is dense, with the
   superficial prefix computed once and reused.

2. ``simulate_policy``: a calibrated device cost model (per-layer FLOPs /
   device FLOP/s + layer-weight I/O, with or without pipeline overlap) that
   reproduces the paper's throughput / energy / memory comparisons on the
   edge devices it names (ORIN / RPI4B / 8GEN3). It is numpy on the host,
   with the reference's arithmetic in the reference's order, so every
   ``SimResult`` field equals the reference's exactly. Only device seconds
   are modelled; no profile describes the GPU the port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ExitGroup:
    exit_idx: int          # index into the exit list
    exit_layer: int        # run layers [superficial_N, exit_layer)
    sample_ids: np.ndarray


@dataclasses.dataclass
class ExitGroupPlan:
    superficial_layers: int
    groups: List[ExitGroup]

    def batches(self, max_batch: int) -> List[Tuple[int, int, np.ndarray]]:
        """(exit_idx, exit_layer, ids) chunks capped at max_batch."""
        out = []
        for g in self.groups:
            for i in range(0, len(g.sample_ids), max_batch):
                out.append((g.exit_idx, g.exit_layer,
                            g.sample_ids[i:i + max_batch]))
        return out


def plan_exit_groups(pred_exit_idx: np.ndarray, exits: Sequence[int],
                     superficial_layers: int) -> ExitGroupPlan:
    pred = np.asarray(pred_exit_idx)
    groups = []
    for i, e in enumerate(exits):
        ids = np.nonzero(pred == i)[0]
        if len(ids):
            groups.append(ExitGroup(exit_idx=i, exit_layer=e, sample_ids=ids))
    return ExitGroupPlan(superficial_layers=superficial_layers, groups=groups)


# ---------------------------------------------------------------------------
# Device cost model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Effective (achieved, not peak) numbers, calibrated so naive-MEM
    throughput matches the paper's Table 2 within ~2x."""
    name: str
    flops: float         # achieved FLOP/s for transformer inference
    io_bw: float         # layer weight-streaming bandwidth, bytes/s
    power_w: float       # active power draw
    idle_w: float
    mem_bytes: float


# ImageBind-huge vision tower ~ 633 GFLOPs / image; Table 2 COCO: ORIN 1.92/s
# layerwise => ~1.2 TFLOP/s effective GPU fp32; RPI4B 0.04/s => ~25 GFLOP/s;
# 8GEN3 0.05/s (INT4 CPU) => ~32 GFLOP/s effective.
ORIN = DeviceProfile("ORIN", flops=1.2e12, io_bw=6e9, power_w=30.0, idle_w=5.0,
                     mem_bytes=32e9)
RPI4B = DeviceProfile("RPI4B", flops=2.5e10, io_bw=8e7, power_w=6.5,
                      idle_w=2.5, mem_bytes=4e9)
GEN3 = DeviceProfile("8GEN3", flops=3.2e10, io_bw=1.2e9, power_w=8.0,
                     idle_w=1.0, mem_bytes=12e9)
DEVICES = {d.name: d for d in (ORIN, RPI4B, GEN3)}


@dataclasses.dataclass(frozen=True)
class ModelCost:
    """Per-sample per-layer cost descriptor for a tower/LM."""
    n_layers: int
    layer_flops: float        # per sample per layer
    layer_bytes: float        # weight bytes per layer (streamed)
    head_flops: float         # exit/confidence head per layer per sample
    frontend_flops: float = 0.0
    embed_head_flops: float = 0.0


def transformer_layer_flops(d_model: int, d_ff: int, seq: int,
                            ff_mult: int = 3) -> float:
    proj = 2 * seq * (4 * d_model * d_model)
    attn = 2 * 2 * seq * seq * d_model
    ffn = 2 * seq * (ff_mult * d_model * d_ff)
    return float(proj + attn + ffn)


def model_cost_from_tower(d_model: int, d_ff: int, n_layers: int, seq: int,
                          bytes_per_param: float = 2.0,
                          embed_out: int = 1024) -> ModelCost:
    lf = transformer_layer_flops(d_model, d_ff, seq)
    lp = (4 * d_model * d_model + 3 * d_model * d_ff + 2 * d_model)
    return ModelCost(n_layers=n_layers, layer_flops=lf,
                     layer_bytes=lp * bytes_per_param,
                     head_flops=2 * d_model * embed_out,
                     frontend_flops=2 * seq * d_model * d_model,
                     embed_head_flops=2 * d_model * embed_out)


def batch_eff(b: float, half: float = 2.0) -> float:
    """Hardware efficiency vs batch size (SIMD/NPU underutilization at small
    batches): eff(1)=0.33, eff(8)=0.8, eff(32)=0.94. Calibrated so
    MEM-batched/MEM matches Table 2's ~2x on CPU devices."""
    return b / (b + half)


@dataclasses.dataclass
class SimResult:
    policy: str
    device: str
    total_s: float
    throughput: float          # items / s
    energy_j: float
    energy_per_item_j: float
    peak_mem_bytes: float
    layers_executed: float     # avg layers per item


def simulate_policy(policy: str, dev: DeviceProfile, cost: ModelCost,
                    exit_layers_per_item: np.ndarray, *,
                    batch: int = 32, layerwise: bool = True,
                    superficial_layers: int = 7,
                    predicted_exits: Optional[np.ndarray] = None) -> SimResult:
    """Simulate embedding `len(exit_layers_per_item)` items.

    exit_layers_per_item: actual exit depth each item needs (full model =
    n_layers for non-exit policies). predicted_exits: the pre-exit
    predictor's depths (Recall policy; >= actual wastes compute, < actual is
    an accuracy miss handled at query time)."""
    items = np.asarray(exit_layers_per_item)
    n = len(items)
    Lh = cost.n_layers
    t_comp_layer = cost.layer_flops / dev.flops
    t_head = cost.head_flops / dev.flops
    t_load = cost.layer_bytes / dev.io_bw if layerwise else 0.0
    act_bytes = 64e6  # working activations, coarse upper bound
    weight_bytes = cost.layer_bytes * Lh

    total = 0.0
    layers_exec = 0.0
    if policy == "mem":           # full model, one item at a time
        per_item = Lh * (t_load + t_comp_layer / batch_eff(1))
        total = n * per_item
        layers_exec = Lh
        peak = (cost.layer_bytes if layerwise else weight_bytes) + act_bytes
    elif policy == "mem_batched":  # full model, batched layer sweeps
        n_b = int(np.ceil(n / batch))
        total = (n_b * Lh * t_load
                 + n * Lh * t_comp_layer / batch_eff(min(batch, n)))
        layers_exec = Lh
        peak = ((cost.layer_bytes if layerwise else weight_bytes)
                + act_bytes * min(batch, n) / 8)
    elif policy == "branchynet":  # per-item confidence exits, no batching
        total = float(np.sum(items)) * (t_load + (t_comp_layer + t_head)
                                        / batch_eff(1))
        layers_exec = float(items.mean())
        peak = (cost.layer_bytes if layerwise else weight_bytes) + act_bytes
    elif policy == "fluid":       # exit-aware preemptive batching
        # Wave simulation: each wave fills to `batch`, sweeps layers until all
        # of the wave exits; loads amortized per wave, compute per alive item
        # at the alive-batch efficiency; confidence heads run every layer.
        order = np.sort(items)[::-1]
        i = 0
        while i < n:
            wave = order[i:i + batch]
            i += batch
            max_l = int(wave.max())
            alive = np.array([(wave > l).sum() for l in range(max_l)])
            alive = np.maximum(alive, 1)
            total += max_l * t_load + float(np.sum(
                alive * (t_comp_layer + t_head) / batch_eff(alive)))
        layers_exec = float(items.mean())
        peak = ((cost.layer_bytes if layerwise else weight_bytes)
                + act_bytes * min(batch, n) / 8)
    elif policy == "recall":
        pred = (items if predicted_exits is None
                else np.asarray(predicted_exits))
        NS = superficial_layers
        # Phase 1: superficial pass for everyone, batched, load/compute
        # pipelined (max instead of sum).
        n_b = int(np.ceil(n / batch))
        eff_b = batch_eff(min(batch, n))
        per_layer = [max(t_load, min(batch, n) * t_comp_layer / eff_b)] * NS
        total += n_b * float(np.sum(per_layer))
        # predictor cost ~ negligible (1MB MLP)
        total += n * (2 * 1e6) / dev.flops
        # Phase 2: exit groups continue from layer NS (superficial reuse);
        # per layer the (next-layer) load pipelines against batch compute.
        depth = np.maximum(pred, NS)
        for e in np.unique(depth):
            grp = int((depth == e).sum())
            span = int(e) - NS
            full_b, rem = divmod(grp, batch)
            total += span * full_b * max(
                t_load, batch * t_comp_layer / batch_eff(batch))
            if rem:
                total += span * max(t_load,
                                    rem * t_comp_layer / batch_eff(rem))
        layers_exec = float(np.maximum(pred, NS).mean())
        peak = ((cost.layer_bytes if layerwise else weight_bytes)
                + act_bytes * min(batch, n) / 8)
    else:
        raise ValueError(policy)

    energy = total * dev.power_w
    return SimResult(policy=policy, device=dev.name, total_s=total,
                     throughput=n / max(total, 1e-12), energy_j=energy,
                     energy_per_item_j=energy / max(n, 1),
                     peak_mem_bytes=peak, layers_executed=layers_exec)


def simulate_all(dev: DeviceProfile, cost: ModelCost,
                 confidence_exits: np.ndarray, recall_exits: np.ndarray,
                 *, batch: int = 32, layerwise: bool = True,
                 superficial_layers: int = 7) -> Dict[str, SimResult]:
    """confidence_exits: per-item exit depth under zero-shot confidence
    thresholds (baselines; conservative/late per paper §3.1). recall_exits:
    per-item exit depth under healing + the pre-exit predictor (earlier)."""
    full = np.full_like(confidence_exits, cost.n_layers)
    out = {
        "mem": simulate_policy("mem", dev, cost, full, layerwise=layerwise),
        "mem_batched": simulate_policy("mem_batched", dev, cost, full,
                                       batch=batch, layerwise=layerwise),
        "branchynet": simulate_policy("branchynet", dev, cost,
                                      confidence_exits, layerwise=layerwise),
        "fluid": simulate_policy("fluid", dev, cost, confidence_exits,
                                 batch=batch, layerwise=layerwise),
        "recall": simulate_policy("recall", dev, cost, recall_exits,
                                  batch=batch, layerwise=layerwise,
                                  superficial_layers=superficial_layers,
                                  predicted_exits=recall_exits),
    }
    return out
