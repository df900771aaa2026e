"""A tiny version of the cell ``kimi_linear.prefill_16k`` for the CPU
tests (its own shrink and limits, as ``new_cells.py`` has for
``moonlight.prefill_8k``)."""
from __future__ import annotations

import copy
import time

import torch

from bench import harness
from bench.tests import tiny

CELLS = ["kimi_linear.prefill_16k"]
BENCH = tiny.BENCH

# the port's plain versions on the CPU against the float32 reference: the
# model runs bfloat16 activations and bf16 q, k, v into the recurrence, so
# at d 64 its numbers read 0.02-0.045 over seeds (a few bf16 steps of
# their scale); the fp8 control reads 0.28-0.36
TINY_LIMITS = {"kimi_linear.prefill_16k": {"latent_err": 0.1,
                                           "state_err": 0.1,
                                           "exit_err": 0.1}}


def tiny_files(workload: str):
    """The cell's files at a tiny size: 4 layers (KDA 1-3, MLA 4: one whole
    period; layer 1 dense), d 64, 4 KDA heads of 16, the MLA at q/k 24, v
    16, 8 experts top-2 with 1 shared."""
    files = harness.resolve(BENCH, workload)
    cfg = copy.deepcopy(files["config"])
    cfg["linear_attn_config"].update(num_heads=4, head_dim=16)
    cfg.update(stage_layers=4, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
               moe_intermediate_size=32, num_experts=8,
               num_experts_per_token=2, num_shared_experts=1,
               vocab_size=256, exit_interval=2, embed_dim=32,
               kda_gate_rank=8)
    files["traffic"].update(batch=2, seq=70, cache=80, pool_batches=3)
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
