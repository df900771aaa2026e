"""Straggler detection & mitigation.

In SPMD every step is a barrier, so one slow host drags the fleet. The
monitor keeps an EWMA/variance of per-host step times, flags hosts whose
z-score exceeds a threshold for `patience` consecutive steps, and emits a
mitigation decision:

  * ``LOG``                  — a transient straggler (data stall): log.
  * ``RESTART_WITHOUT_HOST`` — a persistent straggler: checkpoint, then
    restart without that host.
  * ``REBALANCE``            — step time scales with tokens
    (``TokenSkewMonitor``): rebalance the data shards.

Hardware-independent (timings in, decisions out; numpy only);
``launch/train.py`` feeds it each step's wall time and saves a blocking
checkpoint on ``RESTART_WITHOUT_HOST``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np


class Action(enum.Enum):
    NONE = "none"
    LOG = "log"
    REBALANCE = "rebalance"
    RESTART_WITHOUT_HOST = "restart_without_host"


@dataclasses.dataclass
class Decision:
    action: Action
    host: Optional[int] = None
    reason: str = ""


class StragglerMonitor:
    def __init__(self, n_hosts: int, *, alpha: float = 0.1, z_thresh: float = 3.0,
                 patience: int = 5, warmup: int = 10):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.z_thresh = z_thresh
        self.patience = patience
        self.warmup = warmup
        self.ewma = np.zeros(n_hosts)
        self.ewvar = np.ones(n_hosts) * 1e-6
        self.flag_streak = np.zeros(n_hosts, np.int64)
        self.steps = 0
        self.history: List[Decision] = []

    def record(self, host_times: np.ndarray) -> Decision:
        """host_times: (n_hosts,) seconds for this step."""
        t = np.asarray(host_times, np.float64)
        self.steps += 1
        if self.steps <= self.warmup:
            self.ewma = t if self.steps == 1 else (1 - self.alpha) * self.ewma + self.alpha * t
            self.ewvar = np.maximum((t - self.ewma) ** 2, self.ewvar)
            return Decision(Action.NONE, reason="warmup")
        fleet_med = float(np.median(self.ewma))
        fleet_std = float(np.sqrt(np.median(self.ewvar)) + 1e-9)
        z = (t - fleet_med) / fleet_std
        slow = z > self.z_thresh
        self.flag_streak = np.where(slow, self.flag_streak + 1, 0)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        self.ewvar = (1 - self.alpha) * self.ewvar + self.alpha * (t - self.ewma) ** 2

        worst = int(np.argmax(self.flag_streak))
        if self.flag_streak[worst] >= self.patience:
            d = Decision(Action.RESTART_WITHOUT_HOST, host=worst,
                         reason=f"host {worst} z={z[worst]:.1f} for "
                                f"{int(self.flag_streak[worst])} steps")
        elif slow.any():
            d = Decision(Action.LOG, host=int(np.argmax(z)),
                         reason=f"transient straggler z={z.max():.1f}")
        else:
            d = Decision(Action.NONE)
        if d.action != Action.NONE:
            self.history.append(d)
        return d


class TokenSkewMonitor:
    """Detects data skew (step time correlated with per-host token counts)."""

    def __init__(self, window: int = 50, corr_thresh: float = 0.8):
        self.window = window
        self.corr_thresh = corr_thresh
        self.times: List[np.ndarray] = []
        self.tokens: List[np.ndarray] = []

    def record(self, host_times: np.ndarray, host_tokens: np.ndarray
               ) -> Decision:
        self.times.append(np.asarray(host_times, np.float64))
        self.tokens.append(np.asarray(host_tokens, np.float64))
        self.times = self.times[-self.window:]
        self.tokens = self.tokens[-self.window:]
        if len(self.times) < self.window:
            return Decision(Action.NONE, reason="filling window")
        t = np.stack(self.times).mean(0)
        k = np.stack(self.tokens).mean(0)
        if t.std() < 1e-9 or k.std() < 1e-9:
            return Decision(Action.NONE)
        corr = float(np.corrcoef(t, k)[0, 1])
        if corr > self.corr_thresh and (k.max() / max(k.min(), 1.0)) > 1.2:
            return Decision(Action.REBALANCE,
                            reason=f"time~tokens corr={corr:.2f}")
        return Decision(Action.NONE)
