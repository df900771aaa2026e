"""End-to-end workflow on the PyTorch port: contrastively pretrain a MEM, heal
it with progressive LoRA, train the pre-exit predictor, and report
retrieval quality at every stage (the system developer's workflow of the
paper's Figures 2 and 6; the counterpart of ``train_recall_mem.py``).

Run (CPU, tiny preset):
  PYTHONPATH=src python examples/train_recall_mem_torch.py --device cpu \
      --steps 300
On the card (the default device):
  PYTHONPATH=src python examples/train_recall_mem_torch.py --preset 100m \
      --steps 2000
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.configs.base import MEMConfig, RecallConfig, TowerConfig
from repro_torch.core import exits as EX
from repro_torch.core import preexit as PE
from repro_torch.core.healing import HealConfig, heal_tower
from repro_torch.data.synthetic import multimodal_pairs
from repro_torch.models import imagebind as IB
from repro_torch.optim.adamw import AdamW, _leaves, value_and_grad
from repro_torch.optim.schedule import warmup_cosine

PRESETS = {
    "tiny": MEMConfig(towers=(TowerConfig("vision", 8, 64, 4, 128, 16, 24),
                              TowerConfig("text", 4, 64, 4, 128, 12, 0,
                                          vocab=512),
                              TowerConfig("imu", 3, 64, 4, 128, 10, 6)),
                      embed_dim=64),
    "100m": MEMConfig(towers=(TowerConfig("vision", 12, 512, 8, 2048, 64,
                                          256),
                              TowerConfig("text", 8, 512, 8, 2048, 32, 0,
                                          vocab=8192),
                              TowerConfig("imu", 6, 256, 4, 1024, 24, 6)),
                      embed_dim=512),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--n-data", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ckpt_dir is None:
        with tempfile.TemporaryDirectory() as d:
            return run(args, dev, d)
    return run(args, dev, args.ckpt_dir)


def run(args, dev, ckpt_dir):
    cfg = PRESETS[args.preset]
    rc = RecallConfig(exit_interval=1 if args.preset == "tiny" else 2,
                      superficial_layers=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = IB.mem_init(gen, cfg, rc, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"MEM '{args.preset}': {n_params / 1e6:.1f}M params on {dev}")

    data = multimodal_pairs(0, args.n_data, cfg)
    eval_d = multimodal_pairs(99, 256, cfg)
    opt = AdamW(lr=warmup_cosine(2e-3, 40, args.steps), weight_decay=0.01)
    state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir, save_interval=100, keep=2)

    def step_fn(params, state, batch):
        loss, grads = value_and_grad(
            lambda p, b: IB.mem_contrastive_loss(p, cfg, rc, b)[0], params,
            batch)
        params, state, _ = opt.update(grads, state, params)
        return params, state, loss

    @torch.no_grad()
    def eval_r1(lora=None):
        zv = IB.mem_embed(params, cfg, rc, "vision",
                          torch.as_tensor(eval_d.items["vision"]).to(dev),
                          lora=lora)
        zt = IB.mem_embed(params, cfg, rc, "text",
                          torch.as_tensor(eval_d.items["text"]).to(dev))
        return float(EX.retrieval_at_k(zt, zv, torch.arange(len(zt),
                                                            device=dev), k=1))

    # --- 1) contrastive pretraining ---------------------------------------
    rng = np.random.default_rng(0)
    t0 = time.time()
    for s in range(args.steps):
        idx = rng.integers(0, args.n_data, args.batch)
        batch = {m: torch.as_tensor(v[idx]).to(dev)
                 for m, v in data.items.items()}
        params, state, loss = step_fn(params, state, batch)
        if s % 50 == 0:
            print(f"step {s:5d} loss {float(loss):.3f} "
                  f"({time.time() - t0:.0f}s)")
        if mgr.should_save(s):
            mgr.save(s, {"params": params, "opt": state})
    mgr.save(args.steps, {"params": params, "opt": state}, blocking=True)
    print(f"pretrained in {time.time() - t0:.0f}s; text->vision "
          f"R@1(full) = {eval_r1():.3f}")

    # --- 2) self-supervised exit labels + healing ------------------------
    vis = torch.as_tensor(data.items["vision"][:256]).to(dev)
    with torch.no_grad():
        out = IB.mem_embed_all_exits(params, cfg, rc, "vision", vis)
    labels = EX.optimal_exit_labels(out["exit_embs"], out["exit_embs"][-1])
    hist = np.bincount(labels.cpu().numpy(), minlength=len(out["exits"]))
    print(f"optimal-exit histogram (zero-shot): {hist.tolist()}")

    lora, log = heal_tower(gen, params, cfg, rc, "vision", vis,
                           exit_hist=hist,
                           heal_cfg=HealConfig(lr=2e-3, steps_per_phase=30,
                                               batch=args.batch),
                           device=dev)
    print(f"healed {len(log)} phases; last-phase loss "
          f"{log[-1]['loss_first']:.3f} -> {log[-1]['loss_last']:.3f}; "
          f"text->vision R@1(full, healed) = {eval_r1(lora):.3f}")

    with torch.no_grad():
        out_h = IB.mem_embed_all_exits(params, cfg, rc, "vision", vis,
                                       lora=lora)
    labels_h = EX.optimal_exit_labels(out_h["exit_embs"],
                                      out_h["exit_embs"][-1])
    hist_h = np.bincount(labels_h.cpu().numpy(), minlength=len(out["exits"]))
    print(f"healed exit histogram: {hist_h.tolist()} (mean layer "
          f"{float(EX.mean_exit_depth(labels_h, out['exits'])):.1f} vs "
          f"{float(EX.mean_exit_depth(labels, out['exits'])):.1f} zero-shot)")

    # --- 3) pre-exit predictor ----------------------------------------------
    with torch.no_grad():
        sup = IB.tower_forward(params, cfg, rc, "vision", vis,
                               layer_end=rc.superficial_layers,
                               lora=lora)["pooled"][-1]
    pred, stats = PE.train_predictor(gen, sup, labels_h,
                                     n_exits=len(out["exits"]), steps=200)
    print(f"pre-exit predictor: {stats}")
    print("done — deployable artifacts: params + lora + predictor")
    return {"params": params, "lora": lora, "predictor": pred,
            "stats": stats}


if __name__ == "__main__":
    main()
