"""Embedding runtime (paper §2.2 "offline remembering", Figure 6 left half).

Pipeline per drained queue batch:
  1. superficial pass — first N layers, one dense batch (cached per sample)
  2. pre-exit prediction — tiny MLP on the pooled superficial state
  3. exit-group batching — samples grouped by predicted exit; each group runs
     layers [N, e) as one dense batch
  4. store — coarse embedding + INT4-quantized superficial activations into
     the EmbeddingStore (refinement fuel for §3.4)

Policies: "recall" (the above), "branchynet" (run layer-by-layer, exit on
confidence — no pre-exit, no batching), "fixed" (everyone exits at layer k),
"full" (no early exit). ``lora`` (a healed P-LoRA suite, ``core/healing``)
rides through every tower pass: superficial, continuation, BranchyNet
exits and refinement. The model runs on ``device`` (default CUDA); the
superficial hidden states stay there for the group continuation and are
quantized there for the store's activation cache (the int4_cache kernel on
CUDA), so only their packed bytes and scales reach the host. Refinement
uploads those bytes and dequantizes them on the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MEMConfig, RecallConfig
from repro_torch.core import preexit as PE
from repro_torch.core.scheduler import plan_exit_groups
from repro_torch.core.store import EmbeddingStore
from repro_torch.kernels.int4_cache import ops as int4_ops
from repro_torch.models import imagebind as IB
from repro_torch.models import transformer as T
from repro_torch.tracing import span


@dataclasses.dataclass
class EngineStats:
    n_embedded: int = 0
    layers_executed: float = 0.0
    group_batches: int = 0
    wall_s: float = 0.0
    # cached activations (packed bytes + scales) uploaded to a device for
    # refinement
    refine_h2d_bytes: int = 0

    @property
    def avg_layers(self) -> float:
        return self.layers_executed / max(self.n_embedded, 1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


class EmbeddingEngine:
    def __init__(self, params, cfg: MEMConfig, recall: RecallConfig, *,
                 modality: str = "vision", lora=None,
                 predictor_params=None, policy: str = "recall",
                 fixed_exit: Optional[int] = None, max_batch: int = 64,
                 store: Optional[EmbeddingStore] = None,
                 cache_activations: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.params, self.cfg, self.recall = params, cfg, recall
        self.modality = modality
        self.lora = lora
        self.predictor = predictor_params
        self.policy = policy
        self.fixed_exit = fixed_exit
        self.max_batch = max_batch
        self.store = store if store is not None else EmbeddingStore(
            cfg.embed_dim, device=self.device)
        self.cache_activations = cache_activations
        self.tower = cfg.tower(modality)
        self.exits = recall.exit_layers(self.tower.n_layers)
        self.stats = EngineStats()
        self._queue: List[Tuple[int, np.ndarray]] = []

    # -- model fns -------------------------------------------------------------

    def _superficial(self, x: torch.Tensor):
        """First-N-layer pass; returns hidden state + per-layer pooled states
        (exits at depth <= N read their embedding straight from these)."""
        out = IB.tower_forward(self.params, self.cfg, self.recall,
                               self.modality, x,
                               layer_end=self.recall.superficial_layers,
                               lora=self.lora)
        return out["h"], out["pooled"]  # (B,S,d), (N,B,d)

    def _continue(self, h: torch.Tensor, start: int, end: int) -> torch.Tensor:
        out = IB.tower_forward(self.params, self.cfg, self.recall,
                               self.modality, inputs=None, h_state=h,
                               layer_start=start, layer_end=end,
                               lora=self.lora)
        tp = self.params["towers"][self.modality]
        return T.exit_embedding(tp, out["pooled"][-1], self.cfg.norm_eps)

    # -- queue -------------------------------------------------------------------

    def submit(self, uid: int, item: np.ndarray) -> None:
        self._queue.append((uid, item))

    def submit_batch(self, uids: Sequence[int], items: np.ndarray) -> None:
        for u, it in zip(uids, items):
            self._queue.append((int(u), it))

    # -- execution ---------------------------------------------------------------

    @torch.no_grad()
    def drain(self) -> EngineStats:
        """Embed everything queued; returns cumulative stats."""
        if not self._queue:
            return self.stats
        t0 = time.perf_counter()
        with span("engine.drain"):
            self._drain()
        self.stats.wall_s += time.perf_counter() - t0
        return self.stats

    def _drain(self) -> None:
        with span("engine.collect"):
            uids = np.array([u for u, _ in self._queue])
            items = np.stack([x for _, x in self._queue])
            self._queue.clear()
        N = self.recall.superficial_layers

        if self.policy == "full":
            pred_idx = np.full(len(uids), len(self.exits) - 1)
        elif self.policy == "fixed":
            fe = self.fixed_exit if self.fixed_exit is not None else self.exits[0]
            pred_idx = np.full(len(uids), self.exits.index(fe))
        elif self.policy in ("recall", "branchynet"):
            pred_idx = None  # decided below
        else:
            raise ValueError(self.policy)

        # 1) superficial pass (batched)
        h_parts, pooled_parts = [], []
        for i in range(0, len(items), self.max_batch):
            with span("engine.upload"):
                x = torch.as_tensor(items[i:i + self.max_batch]).to(
                    self.device)
            with span("engine.superficial"):
                h, pooled = self._superficial(x)
            h_parts.append(h)
            pooled_parts.append(pooled)
        h_sup = torch.cat(h_parts)                      # on device
        pooled_all = torch.cat(pooled_parts, dim=1)     # (N, B, d)

        if self.policy == "recall":
            if self.predictor is None:
                raise ValueError("recall policy needs a predictor")
            with span("engine.predict"):
                pred_idx = PE.predict_exit(self.predictor, pooled_all[-1],
                                           n_exits=len(self.exits)
                                           ).cpu().numpy()
        elif self.policy == "branchynet":
            with span("engine.predict"):
                pred_idx = self._branchynet_exits(items)

        # 2+3) exit groups -> dense batched continuation from layer N
        tp = self.params["towers"][self.modality]
        with span("engine.plan"):
            plan = plan_exit_groups(pred_idx, self.exits, N)
        for exit_idx, exit_layer, ids in plan.batches(self.max_batch):
            with span("engine.continue"):
                ids_d = torch.as_tensor(ids, device=self.device)
                if exit_layer <= N:
                    # exit depth within the superficial prefix: the
                    # embedding comes straight from the already-computed
                    # pooled state
                    embs = T.exit_embedding(
                        tp, pooled_all[exit_layer - 1][ids_d],
                        self.cfg.norm_eps)
                    layers_run = N  # superficial pass was still paid
                else:
                    embs = self._continue(h_sup[ids_d], N, exit_layer)
                    layers_run = exit_layer
            with span("engine.to_host"):
                embs = _host(embs)
            self.stats.group_batches += 1
            self.stats.layers_executed += float(len(ids) * layers_run)
            self.store.add_batch(
                uids[ids], embs, [exit_idx] * len(ids),
                [exit_layer] * len(ids), modality=self.modality,
                cached_hs=h_sup[ids_d] if self.cache_activations else None)
        # async bank refresh: scatter the new rows now, behind host work,
        # not on the first query's path
        with span("engine.kick_refresh"):
            self.store.kick_bank_refresh()
        self.stats.n_embedded += len(uids)

    def _branchynet_exits(self, items: np.ndarray, tau: float = 0.95) -> np.ndarray:
        """Per-sample confidence exits (baseline; no batching by design)."""
        out = np.zeros(len(items), np.int64)
        for i in range(len(items)):
            x = torch.as_tensor(items[i:i + 1]).to(self.device)
            embs = _host(IB.mem_embed_all_exits(
                self.params, self.cfg, self.recall, self.modality,
                x, lora=self.lora)["exit_embs"])[:, 0]   # (n_exits, E)
            exit_i = len(self.exits) - 1
            for e in range(len(self.exits) - 1):
                if float(embs[e] @ embs[e + 1]) > tau:
                    exit_i = e
                    break
            out[i] = exit_i
        return out

    # -- refinement hook for the query runtime -----------------------------------

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        self.stats.refine_h2d_bytes += int(a.nbytes)
        return t.pin_memory().to(self.device, non_blocking=True)

    def refine_fn(self) -> Callable:
        """Batched refinement hook for speculative retrieval round 3.

        Called with a uid array it returns ``{uid: fine_emb}`` for every uid
        with a cached activation, running one dense continuation per
        activation-shape group (chunked at ``max_batch``). The cached
        activations travel still packed (pinned, non-blocking) and are
        dequantized on the device (the int4_cache kernel on CUDA)."""
        start = self.recall.superficial_layers
        end = self.tower.n_layers

        @torch.no_grad()
        def refine(uids: np.ndarray) -> Dict[int, np.ndarray]:
            uid_list = [int(u) for u in np.asarray(uids).ravel()]
            cached = self.store._cached_packed(uid_list)
            groups: Dict[Tuple[int, ...], List[int]] = {}
            for u in uid_list:
                if u in cached:
                    groups.setdefault(cached[u][2], []).append(u)
            out: Dict[int, np.ndarray] = {}
            for shape, us in groups.items():
                for i in range(0, len(us), self.max_batch):
                    chunk = us[i:i + self.max_batch]
                    p = self._upload(np.stack([cached[u][0] for u in chunk]))
                    s = self._upload(np.stack([cached[u][1] for u in chunk]))
                    h = int4_ops.dequantize(p, s).reshape(len(chunk), *shape)
                    embs = _host(self._continue(h, start, end))
                    out.update(zip(chunk, embs))
            return out
        return refine
