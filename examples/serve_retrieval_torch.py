"""Serving example on the PyTorch port: embedding runtime + query runtime
under different policies, with batched requests — compares Recall
scheduling against the baselines on real (host) wall-time and store state.
The port's counterpart of ``serve_retrieval.py``, on ``--device`` (the
card by default).

Run:  PYTHONPATH=src python examples/serve_retrieval_torch.py --n-items 192
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.data.synthetic import multimodal_pairs
from repro_torch.launch.serve import build_service
from repro_torch.serving.engine import EmbeddingEngine
from repro_torch.serving.query import QueryEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=192)
    ap.add_argument("--n-queries", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = smoke_variant(get_arch("recall-imagebind"))
    engine, query, info = build_service(spec, n_train=192,
                                        device=args.device)
    params, predictor = engine.params, engine.predictor
    data = multimodal_pairs(5, args.n_items, spec.model)

    print(f"{'policy':12s} {'items/s':>9s} {'avg layers':>11s} "
          f"{'groups':>7s} {'store items':>12s}")
    for policy in ("full", "fixed", "recall", "branchynet"):
        eng = EmbeddingEngine(params, spec.model, spec.recall,
                              modality="vision", predictor_params=predictor,
                              policy=policy, max_batch=48,
                              device=args.device)
        if policy == "fixed":
            eng.fixed_exit = spec.recall.exit_layers(
                spec.model.tower("vision").n_layers)[0]
        n = args.n_items if policy != "branchynet" else min(args.n_items, 32)
        eng.submit_batch(np.arange(n), data.items["vision"][:n])
        s = eng.drain()
        print(f"{policy:12s} {s.n_embedded/s.wall_s:9.1f} "
              f"{s.avg_layers:11.2f} {s.group_batches:7d} {len(eng.store):12d}")

    # queries against the recall store
    eng = EmbeddingEngine(params, spec.model, spec.recall, modality="vision",
                          predictor_params=predictor, policy="recall",
                          max_batch=48, device=args.device)
    eng.submit_batch(np.arange(args.n_items), data.items["vision"])
    eng.drain()
    q = QueryEngine(params, spec.model, spec.recall, store=eng.store,
                    refine_fn=eng.refine_fn(), query_modality="text",
                    device=args.device)
    nq = min(args.n_queries, len(data.items["text"]))
    t0 = time.perf_counter()
    results = q.query_batch(data.items["text"][:nq], k=10)
    dt = time.perf_counter() - t0
    refined = sum(r.n_refined for r in results)
    print(f"\n{nq} speculative queries in {dt:.2f}s "
          f"(one query_batch drain, {dt/nq*1e3:.0f} ms/query "
          f"host), {refined} refinements, store now "
          f"{eng.store.n_fine} fine-grained items")


if __name__ == "__main__":
    main()
