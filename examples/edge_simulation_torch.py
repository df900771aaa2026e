"""Edge-device simulation: reproduce the paper's Table-2-style comparison on
ORIN / RPI4B / 8GEN3 using the calibrated cost model + exit distributions
shaped like the paper's (§3.4: most samples exit in the first few layers
after healing).

The PyTorch port's counterpart of ``edge_simulation.py``: the same table
from ``repro_torch.core.scheduler``.

Run:  PYTHONPATH=src python examples/edge_simulation_torch.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import scheduler as SC


def main():
    # ImageBind-huge vision tower (the paper's workload): 32L, d=1280
    cost = SC.model_cost_from_tower(d_model=1280, d_ff=5120, n_layers=32,
                                    seq=257)
    rng = np.random.default_rng(0)
    n = 828  # TWITTER case study size (§5.5)
    # zero-shot confidence exits: late (paper: avg 21.4 layers)
    confidence = np.clip(rng.normal(21.4, 4, n).astype(int), 8, 32)
    # healed + pre-exit: front-loaded (paper §3.4: >99% before layer 3 on
    # HARSMART; use a moderate image-like distribution, avg ~8)
    recall = np.clip(rng.gamma(2.0, 4.0, n).astype(int) + 2, 2, 32)

    print(f"workload: {n} items; avg exit conf={confidence.mean():.1f} "
          f"recall={recall.mean():.1f} of 32 layers\n")
    print(f"{'device':8s} {'policy':12s} {'items/s':>9s} {'speedup':>8s} "
          f"{'J/item':>8s} {'energy x':>9s} {'peak GB':>8s}")
    for dev_name, dev in SC.DEVICES.items():
        res = SC.simulate_all(dev, cost, confidence, recall, batch=32,
                              superficial_layers=7)
        base = res["mem"]
        for pol, r in res.items():
            print(f"{dev_name:8s} {pol:12s} {r.throughput:9.3f} "
                  f"{r.throughput/base.throughput:8.1f} "
                  f"{r.energy_per_item_j:8.1f} "
                  f"{base.energy_per_item_j/r.energy_per_item_j:9.1f} "
                  f"{r.peak_mem_bytes/1e9:8.2f}")
        print()
    print("paper reference: 14.9x avg throughput, 13.1x avg energy savings; "
          "ORIN/COCO 11.7x (Table 2, Figs 13/16)")


if __name__ == "__main__":
    main()
