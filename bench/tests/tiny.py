"""Tiny versions of the cells for the CPU tests: the configuration files
with every size cut, the traffic files with small pools, and limits set
for these sizes (the port's plain versions on the CPU against the
float32 reference)."""
from __future__ import annotations

import copy
import time

import torch

from bench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")

TINY_LIMITS = {
    "recall.embed": {"missing": 0, "exit_miss": 0, "emb_gap": 5e-5,
                     "act_gap": 5e-5},
    "qwen2.prefill_16k": {"kv_err": 0.05, "exit_err": 0.05},
    "qwen2.prefill_2k": {"kv_err": 0.05, "exit_err": 0.05},
}


def tiny_files(workload: str):
    files = harness.resolve(BENCH, workload)
    cfg = copy.deepcopy(files["config"])
    if cfg["family"] == "mem":
        for t in cfg["towers"]:
            t.update(n_layers=5, d_model=32, n_heads=2, d_ff=64,
                     n_tokens=min(t["n_tokens"], 16),
                     d_input=min(t["d_input"], 24))
            if t.get("vocab"):
                t["vocab"] = 256
        cfg["embed_dim"] = 32
        cfg["recall"].update(exit_interval=1, superficial_layers=2,
                             predictor_hidden=16)
        cfg["mean_exit_layers"] = 3.4
        files["traffic"].update(pool=24, check_sample=8, burst=8,
                                max_batch=4)
    else:
        cfg.update(num_hidden_layers=4, hidden_size=64,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                   intermediate_size=128, vocab_size=512, exit_interval=2,
                   embed_dim=32)
        files["traffic"].update(batch=2, seq=64, cache=64, pool_batches=3)
    files["config"] = cfg
    files["limits"] = dict(TINY_LIMITS[workload])
    return files


def driver(workload: str, seed: int = 5, seconds: float = 0.3):
    files = tiny_files(workload)
    cell = harness.make_cell(files, seed, seconds, torch.device("cpu"))
    return harness.load_driver(files, cell)


def measure(workload: str, seed: int = 5, trace: bool = False,
            seconds: float = 0.3):
    """A whole run of the tiny cell on the CPU (past the look for a
    card): the driver and the result line's keys."""
    drv = driver(workload, seed, seconds)
    with torch.no_grad():
        out = harness.measure(drv, trace=trace, t_start=time.perf_counter(),
                              bench=BENCH, workload=workload)
    return drv, out
