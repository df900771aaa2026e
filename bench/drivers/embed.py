"""RECALL's offline remembering (paper §2.2): bursts of photos, each
``submit_batch`` then ``drain`` on the port's ``EmbeddingEngine`` (the
superficial pass, the pre-exit predictor, the exit-group continuation,
the exit head, the store's int4 rows and the int4 activation cache), in a
closed loop. Photos come from a pool made in set-up, in the order of one
permutation of the pool drawn from the seed, ``pool / burst`` bursts
covering it once, then again, each burst under new uids; the store grows
through the window.

Traffic keys: ``burst``, ``pool``, ``max_batch``, ``policy``,
``check_sample`` (photos of the window held to the reference).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from bench.drivers import recall_common as RC
from bench.drivers.base import Base
from bench.lib.trace import span
from bench.metrics import yardstick as Y

WARM_UID = 1 << 40   # uids of the warm-up burst, apart from the window's


class Driver(Base):
    def setup(self) -> None:
        from repro_torch.serving.engine import EmbeddingEngine
        cfg, t, dev = self.cfg, self.traffic, self.device
        self.mem, self.rc = RC.mem_configs(cfg)
        self.params = RC.make_params(cfg, ["vision"], self.cell.seed, dev)
        self.tp = self.params["towers"]["vision"]
        self.phase("weights")
        pool = RC.make_pool(cfg, t["pool"], self.cell.seed, dev, ["vision"])
        self.photos = pool["vision"]
        # the bursts' photos in host memory, in the order the window sends
        # them: a permutation of the pool drawn from the seed, burst i the
        # (i mod pool/burst)-th slice, so that making a request copies
        # nothing in the window
        b = t["burst"]
        self.order = self.cell.rng(1).permutation(t["pool"])
        self.bursts = self.photos[torch.as_tensor(
            self.order, device=dev)].cpu().numpy().reshape(
            t["pool"] // b, b, *self.photos.shape[1:])
        self.phase("pool")
        feats = RC.features(cfg, self.tp, self.photos)
        self.phase("features")
        self.pred, self.label_depth, self.fit_acc = RC.fit_predictor(
            cfg, feats, pool["difficulty"], self.cell.seed)
        self.phase("predictor")

        def engine():
            return EmbeddingEngine(
                self.params, self.mem, self.rc, modality="vision",
                predictor_params=self.pred, policy=t["policy"],
                max_batch=t["max_batch"], device=dev)

        RC.warm_rmsnorm(cfg, dev, ["vision"])
        warm = engine()
        warm.submit_batch(WARM_UID + np.arange(b), self.bursts[-1])
        warm.drain()
        del warm
        self.phase("warm")
        self.engine = engine()
        self.photo_of = []          # window uid -> pool index

    def run_window(self, win) -> None:
        st, store = self.engine.stats, self.engine.store
        self.c0 = (st.n_embedded, st.layers_executed, store.act_d2h_bytes)
        b = self.traffic["burst"]
        i = 0
        while win.elapsed() < self.cell.seconds:
            j = i % len(self.bursts)
            uids = len(self.photo_of) + np.arange(b)
            self.photo_of.extend(self.order[j * b:(j + 1) * b].tolist())
            with span("bench.submit_batch"):
                self.engine.submit_batch(uids, self.bursts[j])
            with span("bench.drain"):
                self.engine.drain()
            i += 1

    def _window_counts(self):
        st, store = self.engine.stats, self.engine.store
        n = st.n_embedded - self.c0[0]
        return (n, st.layers_executed - self.c0[1],
                store.act_d2h_bytes - self.c0[2])

    def end_to_end(self, win) -> Dict[str, float]:
        n, _, _ = self._window_counts()
        return {"items_per_s": n / win.seconds}

    def record(self, win) -> Dict[str, Any]:
        n, layers, d2h = self._window_counts()
        return {"window_s": win.seconds, "work_s": win.seconds,
                "counters": {"items": n, "layers_executed": layers,
                             "act_d2h_bytes": d2h},
                "flops": {"fp32": Y.photo_flops(self.cfg, layers, n)}}

    def attempted_failed(self) -> tuple:
        n = len(self.photo_of)
        have = self.engine.store.contains(np.arange(n))
        return n, int(n - have.sum())

    def served(self):
        n = len(self.photo_of)
        k = min(self.traffic["check_sample"], n)
        uids = np.sort(self.cell.rng(2).choice(n, size=k, replace=False))
        have = self.engine.store.contains(uids)
        photo_of = {int(u): self.photo_of[int(u)] for u in uids}
        return {"drain": RC.served_from_store(self.engine.store, uids[have],
                                              photo_of),
                "missing": self.attempted_failed()[1]}

    def free(self) -> None:
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, served) -> Dict[str, float]:
        out = RC.judge_drain(self.cfg, self.tp, self.pred, self.photos,
                             served["drain"])
        out["missing"] = float(served["missing"])
        return out

    def standin(self, prec: str):
        n = len(self.photo_of)
        k = min(self.traffic["check_sample"], n)
        uids = np.sort(self.cell.rng(2).choice(n, size=k, replace=False))
        idx = np.array([self.photo_of[int(u)] for u in uids])
        return {"drain": RC.standin_drain(self.cfg, self.tp, self.pred,
                                          self.photos, idx, prec),
                "missing": 0}

    def control_prec(self) -> str:
        """The step below each precision the configuration states."""
        return self.cfg["control"]["vision"]

    def notes(self) -> Dict[str, Any]:
        return {"setup_phases": self.phases,
                "label_mean_exit": self.label_depth,
                "predictor_fit_acc": self.fit_acc}
