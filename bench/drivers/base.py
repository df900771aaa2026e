"""The interface between the harness and a driver.

A driver (``bench/drivers/<name>.py``, named by the ``driver`` key of a
traffic file) defines ``Driver``, a subclass of ``Base``, that runs one
cell of its kind of traffic against the port: ``setup`` builds the system
under test from the configuration and the seed and warms every shape the
traffic takes; ``run_window`` drives the traffic until the window's
seconds are up; ``end_to_end`` and ``record`` turn the window into the
end-to-end metrics and into what the per-layer readers read; ``served``
reads back what the timed path produced, ``judge`` holds it against the
plain reference, and ``standin`` has the reference produce the same
outputs at a lower precision (the control).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    device: torch.device
    limits: Dict[str, float] = field(default_factory=dict)

    def rng(self, *stream: int) -> np.random.Generator:
        """An independent numpy generator for each stream of the seed."""
        return np.random.default_rng([int(self.seed), *stream])


class Base:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.device = cell.device
        self.phases: Dict[str, float] = {}
        self._t = time.perf_counter()

    def start(self, t_start: float) -> None:
        """Open the set-up: what the process spent before it (imports, a
        first run's build of the CUDA libraries) is its first phase."""
        self._t = time.perf_counter()
        self.phases["imports"] = self._t - t_start

    def phase(self, name: str) -> None:
        """Close a phase of the set-up (seconds, synchronized)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def setup(self) -> None:
        raise NotImplementedError

    def run_window(self, win) -> None:
        raise NotImplementedError

    def end_to_end(self, win) -> Dict[str, float]:
        raise NotImplementedError

    def record(self, win) -> Dict[str, Any]:
        raise NotImplementedError

    def attempted_failed(self) -> tuple:
        raise NotImplementedError

    def served(self):
        raise NotImplementedError

    def judge(self, served) -> Dict[str, float]:
        raise NotImplementedError

    def standin(self, prec: str):
        raise NotImplementedError

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
