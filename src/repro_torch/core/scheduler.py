"""Exit-group scheduling (paper Algorithm 1): samples are grouped by
predicted exit so every executed batch is dense, with the superficial
prefix computed once and reused."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ExitGroup:
    exit_idx: int          # index into the exit list
    exit_layer: int        # run layers [superficial_N, exit_layer)
    sample_ids: np.ndarray


@dataclasses.dataclass
class ExitGroupPlan:
    superficial_layers: int
    groups: List[ExitGroup]

    def batches(self, max_batch: int) -> List[Tuple[int, int, np.ndarray]]:
        """(exit_idx, exit_layer, ids) chunks capped at max_batch."""
        out = []
        for g in self.groups:
            for i in range(0, len(g.sample_ids), max_batch):
                out.append((g.exit_idx, g.exit_layer,
                            g.sample_ids[i:i + max_batch]))
        return out


def plan_exit_groups(pred_exit_idx: np.ndarray, exits: Sequence[int],
                     superficial_layers: int) -> ExitGroupPlan:
    pred = np.asarray(pred_exit_idx)
    groups = []
    for i, e in enumerate(exits):
        ids = np.nonzero(pred == i)[0]
        if len(ids):
            groups.append(ExitGroup(exit_idx=i, exit_layer=e, sample_ids=ids))
    return ExitGroupPlan(superficial_layers=superficial_layers, groups=groups)
