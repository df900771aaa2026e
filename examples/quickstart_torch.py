"""Quickstart: the Recall pipeline end-to-end on the PyTorch port.

The port's counterpart of ``quickstart.py``: builds a small multimodal
embedding model, embeds a synthetic stream with early exits scheduled by
the pre-exit predictor, and answers a cross-modal query through
speculative fine-grained retrieval, on ``--device`` (the card by default).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.data.synthetic import multimodal_pairs
from repro_torch.launch.serve import build_service


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1) a reduced ImageBind-style MEM (the paper's architecture family)
    spec = smoke_variant(get_arch("recall-imagebind"))
    print(f"arch: {spec.arch_id}; vision tower "
          f"{spec.model.tower('vision').n_layers} layers; exits at "
          f"{spec.recall.exit_layers(spec.model.tower('vision').n_layers)}")

    # 2) stand up the service: trains the pre-exit predictor from
    # self-supervised exit labels (paper §3.2) and wires the engines
    engine, query, info = build_service(spec, n_train=192,
                                        device=args.device)
    print(f"pre-exit predictor: acc={info['predictor']['acc']:.2f} "
          f"({info['predictor']['n_params']} params)")

    # 3) offline remembering: embed a stream of items with exit-group batching
    data = multimodal_pairs(seed=1, n=128, cfg=spec.model)
    engine.submit_batch(np.arange(128), data.items["vision"])
    stats = engine.drain()
    print(f"embedded {stats.n_embedded} items at avg "
          f"{stats.avg_layers:.1f}/{spec.model.tower('vision').n_layers} "
          f"layers; store = {engine.store.storage_bytes()['total']} bytes")

    # 4) online recall: text query -> speculative filter -> verify -> refine
    res = query.query(data.items["text"][7], k=10)
    print(f"query 7 -> top3 {res.uids[:3].tolist()} "
          f"(refined {res.n_refined} candidates in "
          f"{res.latency_s*1e3:.0f} ms host time)")
    res2 = query.query(data.items["text"][7], k=10)
    print(f"repeat query -> refined {res2.n_refined} "
          f"(permanently upgraded, paper §5.3)")


if __name__ == "__main__":
    main()
