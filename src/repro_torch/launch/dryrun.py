"""Analytic dry run: every (arch x shape) cell laid out on the production
mesh, with no card and no allocation.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b --shape long_500k --window 8192

Each cell's bundle is built on a production mesh of ``meta`` entries
(``launch.mesh.make_production_mesh``): its shardings and abstract
arguments only; no step function is called. For each cell it reports:

* the argument bytes a device, the sum over leaves of the shard shape
  times the item size, split into params, optimizer state and inputs (the
  counterpart of XLA's ``memory_analysis`` argument bytes; the temporary
  bytes have no counterpart and are ``null``);
* ``model_flops_total`` and the ideal-fusion HBM bytes a device
  (``launch.steps.analytic_hbm_bytes_for``);
* the ``Roofline`` on the H100's constants, its FLOPs a device
  ``model_flops_total / n_devices`` (XLA's ``cost_analysis`` has no
  counterpart), its wire bytes 0 (not counted: the port emits no HLO to
  parse) and ``hbm_bytes_upper`` 0.

Cells with a ``skip_reason`` are reported as skipped. Artifacts go to
``--out`` or ``build/repro_torch/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed.mesh_utils import NamedSharding, tree_map
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import analytic_hbm_bytes_for, build_step

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" \
    / "dryrun"


def device_bytes(args, shardings) -> int:
    """Bytes a device holds of the arguments ``args`` laid out by
    ``shardings`` (one tree each): the sum over leaves of shard shape x
    item size (an int leaf, a step count, as the int32 it is saved as)."""
    sizes = []

    def leaf(ab, sh):
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"leaf {ab!r} has no NamedSharding ({sh!r})")
        sizes.append(math.prod(sh.shard_shape(ab.shape)) * ab.dtype.itemsize
                     if isinstance(ab, torch.Tensor) else 4)
    for a, s in zip(args, shardings):
        tree_map(leaf, a, s)
    return sum(sizes)


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 window: int = 0, verbose: bool = True) -> Dict[str, Any]:
    spec = get_arch(arch)
    shape = spec.shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev, "window": window, "status": "ok",
    }
    if shape.skip_reason and window == 0:
        result["status"] = "skipped"
        result["skip_reason"] = shape.skip_reason
        return result

    t0 = time.perf_counter()
    bundle = build_step(spec, shape, device="meta", mesh=mesh,
                        window=window)
    args, shs = bundle.meta["abstract_args"], bundle.meta["in_shardings"]
    rest = 2 if bundle.meta.get("train") else 1
    parts = {"params_bytes": device_bytes(args[:1], shs[:1]),
             "opt_state_bytes": device_bytes(args[1:rest], shs[1:rest]),
             "input_bytes": device_bytes(args[rest:], shs[rest:])}
    hbm = analytic_hbm_bytes_for(spec, shape, bundle, mesh, n_dev)
    roof = H.Roofline(flops_per_device=bundle.model_flops / n_dev,
                      hbm_bytes_per_device=max(hbm, 0.0),
                      wire_bytes_per_device=0.0, n_devices=n_dev,
                      model_flops_total=bundle.model_flops,
                      hbm_bytes_upper=0.0)
    result.update({
        "step": bundle.name,
        "build_s": time.perf_counter() - t0,
        "memory": {"argument_bytes": sum(parts.values()), **parts,
                   "temp_bytes": None},
        "model_flops_total": bundle.model_flops,
        "analytic_hbm_bytes_per_device": hbm,
        "wire_bytes": "not counted",
        "microbatches": bundle.meta.get("mesh_plan", {}).get("microbatches"),
        "rules": bundle.meta["rules"],
        "roofline": roof.as_dict(),
    })
    if verbose:
        r = result["roofline"]
        print(f"[{arch} x {shape_name} @ {result['mesh']}] {bundle.name}: "
              f"args {result['memory']['argument_bytes'] / 2**30:.2f} "
              f"GiB/dev (params {parts['params_bytes'] / 2**30:.2f}, opt "
              f"{parts['opt_state_bytes'] / 2**30:.2f}, inputs "
              f"{parts['input_bytes'] / 2**30:.2f}), compute "
              f"{r['compute_s'] * 1e3:.2f}ms mem {r['memory_s'] * 1e3:.2f}ms "
              f"coll not counted -> {r['bottleneck']} (MFU@roof "
              f"{r['mfu_at_roofline'] * 100:.1f}%)")
    return result


def save_artifact(result: Dict[str, Any], out_dir: Optional[str] = None):
    out_dir = Path(out_dir) if out_dir else ARTIFACT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "w{}".format(result["window"]) if result.get("window") else "native"
    fn = (f"{result['arch']}__{result['shape']}__"
          f"{result['mesh'].replace('x', '_')}__{tag}.json")
    path = out_dir / fn
    path.write_text(json.dumps(result, indent=1))
    return str(path)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention (long_500k extension)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch or --all")

    if args.all:
        cells = [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
    else:
        spec = get_arch(args.arch)
        shapes = [args.shape] if args.shape else [s.name for s in spec.shapes]
        cells = [(args.arch, s) for s in shapes]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                res = analyze_cell(arch, shape, multi_pod=mp,
                                   window=args.window)
                save_artifact(res, args.out)
                if res["status"] == "skipped":
                    print(f"[{arch} x {shape} @ {res['mesh']}] SKIPPED: "
                          f"{res['skip_reason']}")
            except Exception as e:  # noqa: BLE001 -- report every cell
                failures.append((arch, shape, mp, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nDRY-RUN OK")


if __name__ == "__main__":
    main()
