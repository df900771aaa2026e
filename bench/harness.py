"""One run of one cell of ``BENCHMARK.json``.

Everything is found by name: the cell's configuration file is its
``configs`` entry's ``file``; its traffic mix is
``bench/traffic/<traffic>.json``, whose ``driver`` key names the driver
``bench/drivers/<driver>.py``; the limits of the numbers compared are
``bench/limits/<cell>.json``; each per-layer metric is the reader
``bench/metrics/<metric>.py`` (its ``read(rec)`` returns the value, or
None where its cell has nothing for it to read). A later cell, mix or
metric is a new file and a new entry; no file here names one.

The run: refuse without a card (or without the program beside the
benchmark); set up and warm the cell; measure ``--seconds`` of its
traffic (traced with ``--trace 1``); read the device's peak memory; hold
what the timed path produced to the plain reference; print the numbers
compared with their limits on standard error, and the result line last on
standard output. A run whose process holds JAX or the JAX package after
the window exits non-zero without a result.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot measure here; no result is printed."""


def forbidden_modules(names=None) -> List[str]:
    """The top-level names among ``names`` (the modules loaded in this
    process) that are JAX's, its libraries' or the JAX package's,
    compared whole (the name before the first dot: ``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def resolve(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The files of one cell, found by the names in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{workload}.json"
    return {"workload": w, "config": load_json(ROOT / conf["file"]),
            "traffic": traffic, "limits": load_json(limits_path),
            "driver": traffic["driver"]}


def metrics_of(bench: Dict[str, Any], workload: str, kind: str
               ) -> List[Dict[str, Any]]:
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup_environment() -> None:
    """Caches in fixed directories of the checkout (the CUDA libraries
    already build into ``build/repro_torch``), a few host threads, and no
    JAX behind any library; before torch is imported."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TRITON_HOME", str(build / "triton_home"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_cell(files: Dict[str, Any], seed: int, seconds: float, device):
    from bench.drivers.base import Cell
    return Cell(name=files["workload"]["name"], config=files["config"],
                traffic=files["traffic"], seed=seed, seconds=seconds,
                device=device, limits=files["limits"])


def load_driver(files: Dict[str, Any], cell):
    mod = importlib.import_module(f"bench.drivers.{files['driver']}")
    return mod.Driver(cell)


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]
              ) -> Dict[str, Dict[str, float]]:
    """Every number with a limit, in the limits file's order."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def measure(drv, *, trace: bool, t_start: float, bench: Dict[str, Any],
            workload: str) -> Dict[str, Any]:
    """Set up, run the window and judge it; the result line's keys."""
    import torch
    from bench.lib.trace import Window, recording_flash_calls
    from bench.metrics.yardstick import power_limit
    dev = drv.device
    drv.start(t_start)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    calls: List[dict] = []
    with Window(trace, dev) as win:
        if win.trace:
            with recording_flash_calls(calls):
                drv.run_window(win)
        else:
            drv.run_window(win)
    attempted, failed = drv.attempted_failed()
    device: Dict[str, Any] = {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    if dev.type == "cuda":
        device = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(dev), "count": 1,
                  "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
                  "power_limit": power_limit()}
    summary = win.summary()
    if not trace:
        values = drv.end_to_end(win)
        values["setup_s"] = setup_s
        metrics = metrics_of(bench, workload, "end_to_end")
    else:
        rec = drv.record(win)
        rec.update(trace=summary, flash_calls=calls, config=drv.cfg,
                   traffic=drv.traffic)
        metrics = metrics_of(bench, workload, "per_layer")
        values = {m["name"]: load_reader(m["name"]).read(rec)
                  for m in metrics}
        if summary is not None:
            device["busy_s"] = summary.busy_s
            device["window_s"] = summary.window_s
    out = {"attempted": attempted, "failed": failed,
           "metrics": {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in metrics if values.get(m["name"]) is not None},
           "device": device}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    served = drv.served()
    drv.free()
    numbers = drv.judge(served)
    out["checks"] = checks_of(numbers, drv.cell.limits)
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    out["notes"] = drv.notes()
    return out


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise Refused("the program (src/repro_torch) is not beside the "
                          "benchmark")
        bench = load_json(ROOT / "BENCHMARK.json")
        files = resolve(bench, args.workload)
        import torch
        chips = files["workload"]["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise Refused(f"needs {chips} CUDA device(s); "
                          f"torch.cuda.is_available() is "
                          f"{torch.cuda.is_available()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels.build import build_all
        build_all()
        cell = make_cell(files, args.seed, args.seconds,
                         torch.device("cuda:0"))
        with torch.no_grad():
            out = measure(load_driver(files, cell), trace=bool(args.trace),
                          t_start=t_start, bench=bench,
                          workload=args.workload)
        # the window has closed: nothing of JAX may have come in with it
        if forbidden_modules():
            raise Refused(f"loaded in this process: {forbidden_modules()}")
    except Refused as e:
        print(f"bench: refused: {e}", file=sys.stderr)
        return 3
    print_result(out)
    return 0


def print_result(out: Dict[str, Any]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result line, ``checks`` its last key, last on
    standard output."""
    print(f"correct: {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    keys = ["correct", "attempted", "failed", "metrics", "device",
            "breakdown", "notes", "checks"]
    line = {k: out[k] for k in keys if k in out}
    print(json.dumps(line), flush=True)
