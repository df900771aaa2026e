"""Serving driver: embedding runtime + query runtime, end to end.

Queries are served through ``QueryEngine.query_batch`` (one tower pass +
one fused store scan for the whole query drain); ``--per-query`` serves
them one at a time instead.

On the GPU (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
Smoke scale on the CPU (plain versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
With the online IVF coarse filter and its pruned scan:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --index ivf --index-clusters 8 --index-min-rows 16 --nprobe 4 \
      --search-impl ivf
With the async device-bank refresh (bounded staleness):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --search-impl device --bank-refresh async --bank-max-lag-rows 64
With the device bank row-sharded (two shards on the CPU here; on CUDA one
shard a card, the first N):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --search-impl device --search-shards 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.core import exits as EX
from repro_torch.core import preexit as PE
from repro_torch.core.store import EmbeddingStore
from repro_torch.data import synthetic as SYN
from repro_torch.models import imagebind as IB
from repro_torch.serving.engine import EmbeddingEngine
from repro_torch.serving.query import QueryEngine


@torch.no_grad()
def _calibrate(params, cfg, recall, vis, lora):
    all_exits = IB.mem_embed_all_exits(params, cfg, recall, "vision", vis,
                                       lora=lora)
    labels = EX.optimal_exit_labels(all_exits["exit_embs"],
                                    all_exits["exit_embs"][-1])
    sup = IB.tower_forward(params, cfg, recall, "vision", vis,
                           layer_end=recall.superficial_layers,
                           lora=lora)["pooled"][-1]
    return sup, labels, len(all_exits["exits"])


def build_service(spec, *, n_train: int = 256, seed: int = 0,
                  policy: str = "recall", params=None, lora=None,
                  search_impl: str = "auto", device="cuda", **query_kw):
    """Fit the pre-exit predictor from self-supervised labels on a
    calibration set, then stand up the embedding + query engines on
    ``device``. ``query_kw`` goes to ``QueryEngine`` (``bank_refresh``,
    ``bank_max_lag_rows``, ``bank_max_lag_ms``, ``freshness``, ``index``,
    ``search_devices``, ...). ``lora`` (a healed vision-tower LoRA) goes to the calibration and
    to both engines, as the reference passes it: the text tower of the
    query engine gets the vision tower's suite too, which fits only when
    the two towers share their widths (ROADMAP C.4)."""
    device = resolve_device(device)
    cfg, recall = spec.model, spec.recall
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if params is None:
        params = IB.mem_init(gen, cfg, recall, device=device)
    data = SYN.multimodal_pairs(seed, n_train, cfg)
    vis = torch.as_tensor(data.items["vision"]).to(device)
    sup, labels, n_exits = _calibrate(params, cfg, recall, vis, lora)
    del vis
    predictor, stats = PE.train_predictor(
        gen, sup, labels, n_exits=n_exits, hidden=recall.predictor_hidden,
        steps=150)

    store = EmbeddingStore(cfg.embed_dim, device=device)
    engine = EmbeddingEngine(params, cfg, recall, modality="vision",
                             lora=lora, predictor_params=predictor,
                             policy=policy, store=store, device=device)
    query = QueryEngine(params, cfg, recall, store=store,
                        refine_fn=engine.refine_fn(), query_modality="text",
                        lora=lora, search_impl=search_impl, device=device,
                        **query_kw)
    return engine, query, {"predictor": stats,
                           "labels": labels.cpu().numpy()}


def search_devices(device: str, search_impl: str, n_shards: int):
    """The device list of ``--search-shards``: None (the store's default)
    unless ``n_shards`` > 0 with the device scan; then N CPU shards, or the
    first N cards, raising when fewer are visible."""
    if n_shards <= 0 or search_impl != "device":
        return None
    if resolve_device(device).type == "cpu":
        return ["cpu"] * n_shards
    have = torch.cuda.device_count()
    if have < n_shards:
        raise ValueError(f"--search-shards {n_shards} needs {n_shards} "
                         f"cards, {have} visible")
    return [f"cuda:{i}" for i in range(n_shards)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recall-imagebind")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-items", type=int, default=128)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--policy", default="recall",
                    choices=["recall", "branchynet", "fixed", "full"])
    ap.add_argument("--per-query", action="store_true",
                    help="serve queries one at a time instead of one "
                         "query_batch drain")
    ap.add_argument("--search-impl", default="auto",
                    choices=["auto", "numpy", "device", "ivf"],
                    help="store scan backend: 'device' keeps the int4 slab "
                         "resident on the device and scans it with the "
                         "fused kernel; 'ivf' scans only the probed IVF "
                         "clusters (needs --index ivf); 'auto' picks numpy "
                         "on the CPU, and on CUDA 'ivf' once the index is "
                         "trained and holds --index-min-rows rows, else "
                         "'device'")
    ap.add_argument("--search-shards", type=int, default=0,
                    help="with --search-impl device: shard the device bank "
                         "N ways, on the first N cards with --device cuda "
                         "(fewer cards raise), N shards on the CPU with "
                         "--device cpu (0 = every visible card, or one CPU "
                         "shard)")
    ap.add_argument("--bank-refresh", default="sync",
                    choices=["sync", "async"],
                    help="device-bank refresh policy: 'sync' refreshes "
                         "exactly under the store lock per query; 'async' "
                         "moves dirty rows on a background scheduler and "
                         "serves bounded-stale snapshots")
    ap.add_argument("--bank-max-lag-rows", type=int, default=None,
                    help="async only: most dirty-but-unpublished rows a "
                         "query may be served past (default unbounded; 0 = "
                         "fresh-blocking)")
    ap.add_argument("--bank-max-lag-ms", type=float, default=None,
                    help="async only: most age in ms of the oldest "
                         "unpublished write a query may be served past")
    ap.add_argument("--index", default="none", choices=["none", "ivf"],
                    help="coarse-filter index: 'ivf' keeps an online "
                         "mini-batch-k-means quantizer + posting lists")
    ap.add_argument("--index-clusters", type=int, default=64,
                    help="IVF cluster count (coarse codebook size)")
    ap.add_argument("--index-min-rows", type=int, default=None,
                    help="row count where search impl 'auto' cuts over to "
                         "the pruned IVF path (default: the index's 32768)")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="IVF clusters probed per query (default: the "
                         "index's 8)")
    ap.add_argument("--index-auto-grow", action="store_true",
                    help="grow the IVF cluster count toward ~sqrt(n) "
                         "across re-cluster jobs")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if args.smoke:
        spec = smoke_variant(spec)
    engine, query, info = build_service(spec, policy=args.policy,
                                        search_impl=args.search_impl,
                                        search_devices=search_devices(
                                            args.device, args.search_impl,
                                            args.search_shards),
                                        device=args.device,
                                        bank_refresh=args.bank_refresh,
                                        bank_max_lag_rows=args.bank_max_lag_rows,
                                        bank_max_lag_ms=args.bank_max_lag_ms,
                                        index=args.index,
                                        index_clusters=args.index_clusters,
                                        index_min_rows=args.index_min_rows,
                                        nprobe=args.nprobe,
                                        index_auto_grow=args.index_auto_grow)
    print(f"predictor: {info['predictor']}")

    data = SYN.multimodal_pairs(1, args.n_items, spec.model)
    engine.submit_batch(np.arange(args.n_items), data.items["vision"])
    stats = engine.drain()
    print(f"embedded {stats.n_embedded} items, avg layers "
          f"{stats.avg_layers:.1f}/{spec.model.tower('vision').n_layers}, "
          f"{stats.n_embedded / stats.wall_s:.1f} items/s (host wall, "
          f"{args.device})")
    print(f"store: {engine.store.storage_bytes()}")

    nq = min(args.n_queries, len(data.items["text"]))
    t0 = time.perf_counter()
    if args.per_query:
        results = [query.query(data.items["text"][qi], k=10)
                   for qi in range(nq)]
    else:
        results = query.query_batch(data.items["text"][:nq], k=10)
    dt = time.perf_counter() - t0
    hits = sum(int(len(r.uids) > 0 and r.uids[0] == qi)
               for qi, r in enumerate(results))
    mode = "per-query" if args.per_query else "batched"
    print(f"{nq} {mode} queries in {dt:.2f}s "
          f"({dt / nq * 1e3:.0f} ms/query host), "
          f"{sum(r.n_refined for r in results)} refinements")
    print(f"R@1 (untrained model, sanity only): {hits / nq:.2f}")
    if engine.store.device_bank is not None:
        print(f"device bank: {engine.store.device_bank.stats()}")
    if engine.store.ivf_index is not None:
        print(f"ivf index: {engine.store.ivf_index.stats()}, "
              f"fallbacks={engine.store.ivf_fallbacks}")
    ref = engine.store.bank_refresher
    if ref is not None:
        print(f"bank refresh: async, epochs={ref.n_epochs}, "
              f"blocking={ref.n_blocking}, stale={ref.n_stale_served}, "
              f"lag={ref.lag()}")
        engine.store.set_bank_refresh("sync")  # drain + stop the thread
    return results


if __name__ == "__main__":
    main()
