"""One traced run of a cell with its time charged to the program's spans:

    python3 bench/attribute.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

The run is ``bench/run.py --trace 1``'s (the harness's ``measure``, its
result line printed as that run prints it); the profiler's events are
then read again by ``bench/lib/spans.py``, and one more JSON line gives
the idle and device seconds of each program span by kernel class, the
idle gaps labelled with the span, the share of device time linked to no
launch, and the spans' readings (``spans.readings``). ``--out`` writes
that line to a file too. Needs a card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402
from bench.lib import spans as SP  # noqa: E402
from bench.lib import trace  # noqa: E402


def attribute(drv, bench, workload: str, t_start: float):
    """The harness's traced ``measure`` of ``drv`` and the line of its
    spans: (result, spans line)."""
    kept = {}

    class Window(trace.Window):
        def summary(self):
            kept["events"] = None if self.prof is None \
                else SP.kineto_events(self.prof)
            return super().summary()

    record = drv.record

    def keep_record(win):
        kept["rec"] = record(win)
        return kept["rec"]

    drv.record = keep_record
    with mock.patch.object(trace, "Window", Window):
        out = harness.measure(drv, trace=True, t_start=t_start,
                              bench=bench, workload=workload)
    t1 = time.perf_counter()
    st = None if kept.get("events") is None else SP.SpanTrace(kept["events"])
    # the accepted idle share of the same run, which the spans' idle
    # shares and the harness's remainder add up to
    idle = [m["value"] for n, m in out["metrics"].items()
            if n.startswith("idle_share.")]
    line = {"workload": workload, "readings": SP.readings(st, kept["rec"]),
            "idle_share": idle[0] if idle else None,
            "seconds": {"setup_and_measure": t1 - t_start,
                        "spans": time.perf_counter() - t1}}
    if st is not None:
        line.update(window_s=st.window_s, busy_s=st.busy_s,
                    table=st.table(), stages=st.table(stage=True),
                    kernels=st.top_kernels(),
                    stage_kernels=st.top_kernels(stage=True),
                    gaps=st.top_gaps(), counts=st.counts,
                    device=out["device"])
    return out, line


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.setup_environment()
    import torch
    if not torch.cuda.is_available():
        print("attribute: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.build import build_all
    build_all()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.resolve(bench, args.workload)
    cell = harness.make_cell(files, args.seed, args.seconds,
                             torch.device("cuda:0"))
    with torch.no_grad():
        out, line = attribute(harness.load_driver(files, cell), bench,
                              args.workload, t_start)
    harness.print_result(out)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
