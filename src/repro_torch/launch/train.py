"""Training loop on one device: the step builders (``launch/steps``),
the checkpoint manager (atomic, async, retained), the straggler monitor
and the data loader, wired as the reference's ``launch/train.py`` wires
them. Runs at smoke scale on the CPU and at full width on the card.

Usage (smoke, CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.data import synthetic as SYN
from repro_torch.data.pipeline import ShardedLoader
from repro_torch.distributed.straggler import Action, StragglerMonitor
from repro_torch.launch.steps import build_step
from repro_torch.models import gnn as G
from repro_torch.models import imagebind as IB
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamW


def make_train_data(spec, shape, n: int, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """``n`` training examples of ``spec``'s family. The gnn family has
    none: it raises ``ValueError("gnn")``, as the reference does (its
    graphs come from ``data.synthetic.sbm_graph`` and
    ``data.sampler.sample_subgraph``)."""
    if spec.family == "lm":
        toks = SYN.lm_tokens(seed, n, shape.seq_len + 1, spec.model.vocab)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if spec.family == "recsys":
        if spec.model.kind == "dlrm":
            return SYN.criteo_like(seed, n, spec.model)
        return SYN.seq_recsys(seed, n, spec.model)
    if spec.family == "mem":
        return dict(SYN.multimodal_pairs(seed, n, spec.model).items)
    raise ValueError(spec.family)


def init_params(spec, seed: int, device, shape=None):
    """The family's random init from a generator on ``device`` seeded by
    ``seed`` (a gnn's input width is ``shape``'s ``d_feat``, as its step
    takes it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if spec.family == "lm":
        return T.lm_init(gen, spec.model, spec.recall, device=device)
    if spec.family == "mem":
        return IB.mem_init(gen, spec.model, spec.recall, device=device)
    if spec.family == "recsys":
        return R.recsys_init(gen, spec.model, device=device)
    if spec.family == "gnn":
        cfg = replace(spec.model, d_feat=(shape.d_feat if shape else 0)
                      or spec.model.d_feat)
        return G.gnn_init(gen, cfg, spec.recall,
                          embed_out=min(1024, cfg.d_hidden * 8),
                          device=device)
    raise ValueError(spec.family)


def train_loop(spec, shape, *, device="cuda", steps: int = 50,
               ckpt_dir: Optional[str] = None, save_interval: int = 20,
               n_data: int = 512, log_every: int = 10, resume: bool = True,
               seed: int = 0, **train_kw) -> Dict[str, Any]:
    """Build, (maybe) restore from ``ckpt_dir``, and run the train step of
    ``shape`` (a ShapeConfig or the name of one of ``spec``'s) for
    ``steps`` steps. ``train_kw`` goes to ``build_step``. Returns the
    params, the optimizer state, the step losses and grad norms (floats),
    each step's host seconds (from the step's call to its loss read back)
    and the final step. Each batch keeps only the arrays the step takes
    (``meta["inputs"]``), as the reference's loop does."""
    dev = resolve_device(device)
    shape_cfg = spec.shape(shape) if isinstance(shape, str) else shape
    bundle = build_step(spec, shape_cfg, device=dev, **train_kw)
    params = init_params(spec, seed, dev, shape_cfg)
    opt_state = AdamW().init(params)  # zero moments, step 0

    mgr = None
    start_step = 0
    loader_state = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, save_interval=save_interval)
        if resume:
            restored, manifest = mgr.restore_or_none(
                {"params": params, "opt": opt_state}, device=dev)
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                start_step = manifest["step"]
                loader_state = manifest["meta"].get("loader")
                print(f"[train] resumed from step {start_step}")

    data = make_train_data(spec, shape_cfg, n_data, seed)
    loader = ShardedLoader(data, global_batch=shape_cfg.global_batch,
                           seed=seed)
    if loader_state:
        loader.load_state_dict(loader_state)

    monitor = StragglerMonitor(n_hosts=1, warmup=3)
    it = iter(loader)
    losses, grad_norms, step_s = [], [], []
    try:
        for step in range(start_step, start_step + steps):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in next(it).items()
                     if k in bundle.meta["inputs"]}
            t0 = time.perf_counter()
            params, opt_state, metrics = bundle.fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            step_s.append(dt)
            decision = monitor.record(np.array([dt]))
            state = {"params": params, "opt": opt_state}
            if decision.action == Action.RESTART_WITHOUT_HOST and mgr:
                mgr.save(step, state, meta={"loader": loader.state_dict()},
                         blocking=True)
            if log_every and (step % log_every == 0):
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if mgr and mgr.should_save(step):
                mgr.save(step, state, meta={"loader": loader.state_dict()})
    finally:
        it.close()
    if mgr:
        mgr.save(start_step + steps, {"params": params, "opt": opt_state},
                 meta={"loader": loader.state_dict()}, blocking=True)
        mgr.ckpt.wait()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "grad_norms": grad_norms, "step_s": step_s,
            "final_step": start_step + steps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced CPU-runnable variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-interval", type=int, default=20)
    ap.add_argument("--n-data", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if args.smoke:
        spec = smoke_variant(spec)
    shape = args.shape or next(s.name for s in spec.shapes
                               if s.kind == "train")
    out = train_loop(spec, shape, device=args.device, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, save_interval=args.save_interval,
                     n_data=args.n_data)
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}) @ step {out['final_step']}")


if __name__ == "__main__":
    main()
