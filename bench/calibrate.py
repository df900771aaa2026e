"""Readings that the limits of ``bench/limits/<cell>.json`` are set from
(not run by the benchmark's own runs):

    python3 bench/calibrate.py --workload <name> --seeds 101 102 ... \
        --control-seeds 101 102 103 --seconds 4 [--out FILE]

For each seed, one process-local run of the cell at its own size and
load: set up from the seed, a short window, the served outputs judged
against the plain reference (the lower readings); for each control seed
also the reference put in the program's place at the step below each
precision the configuration states (``Driver.standin``), judged alike
(the upper readings). One JSON line per judgement; a summary line last.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402


def run(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.setup_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.build import build_all
    build_all()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.resolve(bench, args.workload)
    lines = []
    sound, control = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        cell = harness.make_cell(files, seed, args.seconds,
                                 torch.device("cuda:0"))
        drv = harness.load_driver(files, cell)
        with torch.no_grad():
            drv.setup()
            from bench.lib.trace import Window
            with Window(False, drv.device) as win:
                drv.run_window(win)
            served = drv.served()
            drv.free()
            rows = []
            if seed in args.seeds:
                rows.append(("program", drv.judge(served)))
            del served
            if seed in args.control_seeds:
                prec = drv.control_prec()
                rows.append(("control " + prec, drv.judge(drv.standin(prec))))
        for who, nums in rows:
            line = {"workload": args.workload, "seed": seed, "who": who,
                    "numbers": nums, "notes": drv.notes(),
                    "s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            lines.append(line)
            into = sound if who == "program" else control
            for k, v in nums.items():
                into.setdefault(k, []).append(v)
        del drv
        torch.cuda.empty_cache()
    summary = {"workload": args.workload,
               "lower": {k: max(v) for k, v in sound.items()},
               "upper": {k: min(v) for k, v in control.items()},
               "n_seeds": len(args.seeds),
               "n_control": len(args.control_seeds)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(run())
