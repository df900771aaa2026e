"""The program's spans in a traced window, with the device's idle and busy
time charged to them.

The port opens ``record_function`` ranges named by ``repro_torch.tracing``
(``engine.*``, ``store.*``, ``layer.*``, ``lm.*``, ``query.*``) while a
profiler records; the profiler keeps them on the clock of its device
events. ``SpanTrace`` reads the same events as ``trace.TraceSummary``:

* idle: each idle instant of the window (no device operation running) goes
  to the innermost open span of the idle families (``engine.*``,
  ``store.*``, ``query.*``); a gap is cut at span boundaries. Idle outside
  every such span is the harness's (``HARNESS``).
* device: each device operation goes to the innermost program span open at
  its launch: the start of the host op whose ``id`` is the operation's
  ``linked_correlation_id``, else of the runtime call (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) with the operation's own
  correlation ``id``. Operations with neither are ``UNLINKED``; operations
  launched outside every program span are ``OUTSIDE``. Each operation is
  also charged to its stage, the innermost span of the idle families open
  at its launch (a layer's kernels to the ``engine.superficial`` or
  ``engine.continue`` that ran the layer). Keyed by span or stage and
  ``yardstick.kernel_class``, or by kernel name.
* gaps: the idle pieces labelled ``<bench span> | <program span> | <host
  op>``, as ``TraceSummary``'s labels with the program span between.

A span's own annotation on the device timeline is dropped by name, as
``TraceSummary`` drops it: busy time counts no span. Times in seconds.

The events are the profiler's own (``kineto_events``): the
``FunctionEvent``s of ``prof.events()`` carry no ``linked_correlation_id``
in every torch release (2.11 has none).
"""
from __future__ import annotations

import heapq
import re
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.lib.trace import _merge
from bench.metrics.yardstick import PEAK_FLOPS, kernel_class

PROGRAM = ("engine.", "store.", "layer.", "lm.", "query.")
IDLE_FAMILIES = ("engine.", "store.", "query.")
HARNESS = "bench (harness)"
OUTSIDE = "(outside program spans)"
UNLINKED = "(unlinked)"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
LABEL_CHARS = 64

Span = Tuple[float, float, str]
Range = namedtuple("Range", "start end")
Event = namedtuple("Event", "name device_type time_range id "
                            "linked_correlation_id")


def kineto_events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile`` as Kineto
    recorded them (times in microseconds), with their correlation ids."""
    out = []
    for k in prof.profiler.kineto_results.events():
        out.append(Event(k.name(), k.device_type(),
                         Range(k.start_ns() / 1e3, k.end_ns() / 1e3),
                         k.correlation_id(), k.linked_correlation_id()))
    return out


def steps(spans: Sequence[Span]) -> Tuple[np.ndarray, List[Optional[str]]]:
    """The innermost open span as a step function: on ``[breaks[i],
    breaks[i + 1])`` it is ``labels[i]`` (None where none is open). The
    innermost is the open span started last (the shorter of two started
    together): on one thread, the top of the nesting."""
    pts = []
    for i, (a, b, _) in enumerate(spans):
        if b > a:
            pts.append((a, 1, i))
            pts.append((b, 0, i))
    pts.sort()
    heap: List[Tuple[float, float, int]] = []
    closed = set()
    breaks: List[float] = []
    labels: List[Optional[str]] = []
    j = 0
    while j < len(pts):
        t = pts[j][0]
        while j < len(pts) and pts[j][0] == t:
            _, kind, i = pts[j]
            if kind:
                a, b, _ = spans[i]
                heapq.heappush(heap, (-a, b - a, i))
            else:
                closed.add(i)
            j += 1
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        top = spans[heap[0][2]][2] if heap else None
        if not labels or labels[-1] != top:
            breaks.append(t)
            labels.append(top)
    return np.asarray(breaks, np.float64), labels


def at(step: Tuple[np.ndarray, List[Optional[str]]], ts: np.ndarray,
       default: str) -> List[str]:
    """The step function's label at each time of ``ts``."""
    breaks, labels = step
    if not len(breaks):
        return [default] * len(ts)
    idx = np.searchsorted(breaks, ts, side="right") - 1
    return [default if i < 0 or labels[i] is None else labels[i]
            for i in idx.tolist()]


class SpanTrace:
    def __init__(self, events):
        dev, host, bounds = [], [], None
        for e in events:
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append(e)
            else:
                host.append(e)
                if e.name == "bench.window":
                    bounds = (tr.start, tr.end)
        names = {h.name for h in host}
        dev = [d for d in dev if d.name not in names]
        self.window_s = 0.0 if bounds is None \
            else (bounds[1] - bounds[0]) / 1e6
        merged = _merge([(d.time_range.start, d.time_range.end)
                         for d in dev])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self.idle_s: Dict[str, float] = {}
        self.gaps: Dict[str, float] = {}
        # (innermost span, stage, kernel name) -> device seconds
        self.op_s: Dict[Tuple[str, str, str], float] = {}
        self.counts: Dict[str, int] = {}
        for h in host:
            if h.name.startswith(PROGRAM):
                self.counts[h.name] = self.counts.get(h.name, 0) + 1
        self._charge_idle(merged, host, bounds)
        self._charge_device(dev, host)

    # -- idle --------------------------------------------------------------

    def _charge_idle(self, merged, host, bounds) -> None:
        if bounds is None:
            return
        edges = [bounds[0]] + [x for iv in merged for x in iv] + [bounds[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        if not gaps:
            return
        prog = steps([(h.time_range.start, h.time_range.end, h.name)
                      for h in host if h.name.startswith(IDLE_FAMILIES)])
        # every gap cut at the program spans' boundaries
        cuts = prog[0]
        lo, hi = [], []
        for a, b in gaps:
            inner = cuts[np.searchsorted(cuts, a, side="right"):
                         np.searchsorted(cuts, b, side="left")].tolist()
            pts = [a] + inner + [b]
            lo.extend(pts[:-1])
            hi.extend(pts[1:])
        lo, hi = np.asarray(lo), np.asarray(hi)
        secs = (hi - lo) / 1e6
        owner = at(prog, lo, HARNESS)
        for o, s in zip(owner, secs.tolist()):
            self.idle_s[o] = self.idle_s.get(o, 0.0) + s
        mid = (lo + hi) / 2
        bench = at(steps([(h.time_range.start, h.time_range.end, h.name)
                          for h in host if h.name.startswith("bench.")
                          and h.name != "bench.window"]), mid, HARNESS)
        ops = at(steps([(h.time_range.start, h.time_range.end, h.name)
                        for h in host if h.name.startswith("aten::")]),
                 mid, "python")
        for bn, o, op, s in zip(bench, owner, ops, secs.tolist()):
            label = " | ".join([bn] + ([o] if o != HARNESS else []) + [op])
            label = label[:LABEL_CHARS]
            self.gaps[label] = self.gaps.get(label, 0.0) + s

    # -- device ------------------------------------------------------------

    def _charge_device(self, dev, host) -> None:
        ops: Dict[int, float] = {}
        runtime: Dict[int, float] = {}
        spans: List[Span] = []
        for h in host:
            tr = h.time_range
            if h.name.startswith(PROGRAM):
                spans.append((tr.start, tr.end, h.name))
            elif RUNTIME.match(h.name):
                runtime[h.id] = tr.start
            elif not h.linked_correlation_id:
                ops[h.id] = tr.start
        launched, rows = [], []
        for d in dev:
            t = ops.get(d.linked_correlation_id) \
                if d.linked_correlation_id else None
            if t is None:
                t = runtime.get(d.id)
            if t is None:
                self._add(UNLINKED, UNLINKED, d)
            else:
                launched.append(t)
                rows.append(d)
        ts = np.asarray(launched, np.float64)
        stage = [(a, b, n) for a, b, n in spans if n.startswith(IDLE_FAMILIES)]
        for inner, outer, d in zip(at(steps(spans), ts, OUTSIDE),
                                   at(steps(stage), ts, OUTSIDE), rows):
            self._add(inner, outer, d)

    def _add(self, span: str, stage: str, d) -> None:
        key = (span, stage, d.name)
        tr = d.time_range
        self.op_s[key] = self.op_s.get(key, 0.0) + (tr.end - tr.start) / 1e6

    # -- readings ----------------------------------------------------------

    def span_idle_s(self) -> Dict[str, float]:
        return dict(self.idle_s)

    def span_device_s(self, stage: bool = False
                      ) -> Dict[Tuple[str, str], float]:
        """(span, kernel class) -> device seconds; by stage with
        ``stage``."""
        out: Dict[Tuple[str, str], float] = {}
        for (span, st, name), v in self.op_s.items():
            key = (st if stage else span, kernel_class(name))
            out[key] = out.get(key, 0.0) + v
        return out

    def idle_share(self, prefix: str) -> Optional[float]:
        """The idle seconds charged to spans named ``prefix*`` over the
        window, in %."""
        if not self.window_s:
            return None
        s = sum(v for k, v in self.idle_s.items() if k.startswith(prefix))
        return 100.0 * s / self.window_s

    def span_time(self, name: str) -> float:
        """Device seconds charged to the span ``name``, every kernel."""
        return sum(v for (o, _, _), v in self.op_s.items() if o == name)

    def unlinked_share(self) -> Optional[float]:
        total = sum(self.op_s.values())
        if not total:
            return None
        return 100.0 * self.span_time(UNLINKED) / total

    def table(self, stage: bool = False) -> Dict[str, Dict[str, float]]:
        """span (or stage) -> {"idle": s, <kernel class>: s, ...}, the most
        time first."""
        rows: Dict[str, Dict[str, float]] = {}
        for o, s in self.idle_s.items():
            rows.setdefault(o, {})["idle"] = s
        for (o, c), s in self.span_device_s(stage).items():
            rows.setdefault(o, {})[c] = s
        return dict(sorted(rows.items(), key=lambda kv: -sum(kv[1].values())))

    def top_kernels(self, n: int = 6, stage: bool = False
                    ) -> Dict[str, List[list]]:
        """span (or stage) -> its ``n`` kernels with the most device time,
        [name, s]."""
        by: Dict[str, Dict[str, float]] = {}
        for (span, st, name), v in self.op_s.items():
            row = by.setdefault(st if stage else span, {})
            row[name] = row.get(name, 0.0) + v
        return {k: [[m, v] for m, v in sorted(row.items(),
                                              key=lambda kv: -kv[1])[:n]]
                for k, row in by.items()}

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:n]]


def mlp_flops(tokens: float, d: int, d_ff: int) -> float:
    """The SwiGLU's three products over ``tokens`` tokens (gate, up,
    down), as ``yardstick.encoder_layer_flops`` counts them."""
    return 2.0 * tokens * 3 * d * d_ff


def mlp_tokens(cfg: Dict, counters: Dict) -> Tuple[float, int, int]:
    """(tokens through an MLP block in the window, d, d_ff) of a cell's
    configuration and the driver's counters."""
    if cfg.get("family") == "mem":
        t = next(t for t in cfg["towers"] if t["modality"] == "vision")
        return (counters["layers_executed"] * (t["n_tokens"] + 1),
                t["d_model"], t["d_ff"])
    return (counters["tokens"] * cfg["num_hidden_layers"],
            cfg["hidden_size"], cfg["intermediate_size"])


def readings(st: Optional[SpanTrace], rec: Dict) -> Dict[str, Optional[float]]:
    """The readings of the spans (each None without a trace):
    ``engine_idle_share`` and ``store_idle_share`` (%, of the window),
    ``harness_idle_share`` (the rest of the idle), ``mlp_mfu`` (the MLP
    blocks' model FLOPs at the peak of the window's dtype over the device
    time charged to ``layer.mlp``, %) and ``unlinked_share`` (% of device
    time)."""
    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("engine_idle_share", "store_idle_share", "harness_idle_share",
         "mlp_mfu", "unlinked_share"))
    if st is None or not st.window_s:
        return out
    out["engine_idle_share"] = st.idle_share("engine.")
    out["store_idle_share"] = st.idle_share("store.")
    out["harness_idle_share"] = st.idle_share(HARNESS)
    out["unlinked_share"] = st.unlinked_share()
    mlp_s = st.span_time("layer.mlp")
    (dtype,) = rec["flops"]
    if mlp_s:
        tokens, d, d_ff = mlp_tokens(rec["config"], rec["counters"])
        out["mlp_mfu"] = 100.0 * mlp_flops(tokens, d, d_ff) \
            / PEAK_FLOPS[dtype] / mlp_s
    return out
