"""A tiny version of the cell ``moonlight.prefill_8k`` for the CPU tests
(its own shrink and limits: ``tiny.py`` covers the cells before it)."""
from __future__ import annotations

import copy
import time

import torch

from bench import harness
from bench.tests import tiny

CELLS = ["moonlight.prefill_8k"]
BENCH = tiny.BENCH

# the port's plain versions on the CPU against the float32 reference: the
# MLA model runs bfloat16 activations, so its numbers sit near a bf16 step
# of their scale (~1e-2 of it)
TINY_LIMITS = {"moonlight.prefill_8k": {"latent_err": 0.05,
                                        "exit_err": 0.05}}


def tiny_files(workload: str):
    files = harness.resolve(BENCH, workload)
    cfg = copy.deepcopy(files["config"])
    cfg.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=1, vocab_size=256,
               exit_interval=2, embed_dim=32)
    files["traffic"].update(batch=2, seq=40, cache=48, pool_batches=3)
    files["config"] = cfg
    files["limits"] = dict(TINY_LIMITS[workload])
    return files


def driver(workload: str, seed: int = 5, seconds: float = 0.3):
    files = tiny_files(workload)
    cell = harness.make_cell(files, seed, seconds, torch.device("cpu"))
    return harness.load_driver(files, cell)


def measure(workload: str, seed: int = 5, trace: bool = False,
            seconds: float = 0.3):
    drv = driver(workload, seed, seconds)
    with torch.no_grad():
        out = harness.measure(drv, trace=trace, t_start=time.perf_counter(),
                              bench=BENCH, workload=workload)
    return drv, out
