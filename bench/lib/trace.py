"""The measured window, traced or not.

``Window`` times a window on the host clock; with ``trace`` it runs
``torch.profiler`` (CPU and CUDA activities) over it and ``summary``
reduces the trace: device time by kernel name, the busy time (the union
of every device operation's interval), the idle gaps between them
labelled by what the host was doing (the enclosing ``bench.*`` span of
the harness and the innermost torch op), and the ``breakdown`` the
result line carries.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench.metrics.yardstick import kernel_class


def span(name: str):
    """A host span in the trace (a no-op cost when nothing records)."""
    return torch.profiler.record_function(name)


class Window:
    def __init__(self, trace: bool, device: torch.device):
        self.trace = trace and device.type == "cuda"
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> "Window":
        self.sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._span = span("bench.window")
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc) -> None:
        self.sync()
        self.t1 = time.perf_counter()
        self._span.__exit__(*exc)
        if self.prof is not None:
            self.prof.__exit__(*exc)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self) -> Optional["TraceSummary"]:
        if self.prof is None:
            return None
        return TraceSummary(self.prof.events(), self.seconds)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class TraceSummary:
    """Reductions of one traced window (times in seconds)."""

    def __init__(self, events, window_s: float):
        self.window_s = window_s
        dev, host, bounds = [], [], None
        for e in events:
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.name, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
                if e.name == "bench.window":
                    bounds = (tr.start, tr.end)
        # a host span also shows on the device's timeline (as a user
        # annotation): it is no operation of the device
        spans = {h[0] for h in host}
        dev = [d for d in dev if d[0] not in spans]
        self.kernel_s: Dict[str, float] = {}
        for name, a, b in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) \
                + (b - a) / 1e6
        merged = _merge([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self._gaps = self._label_gaps(merged, host, bounds)

    def class_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s in self.kernel_s.items():
            c = kernel_class(name)
            out[c] = out.get(c, 0.0) + s
        return out

    def kernel_time(self, fragment: str) -> float:
        return sum(s for n, s in self.kernel_s.items() if fragment in n)

    @staticmethod
    def _label_gaps(merged, host, bounds, n_gaps: int = 1000):
        """Idle seconds of the ``n_gaps`` longest gaps, summed by label."""
        if bounds is None or not merged:
            return {}
        edges = [bounds[0]] + [x for iv in merged for x in iv] + [bounds[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])

        def table(pred):
            rows = [h for h in host if pred(h[0])]
            return ([r[0] for r in rows],
                    np.array([r[1] for r in rows], np.float64),
                    np.array([r[2] for r in rows], np.float64))

        def innermost(tab, mid, default):
            names, a, b = tab
            hit = np.nonzero((a <= mid) & (b >= mid))[0]
            if not hit.size:
                return default
            return names[hit[np.argmin(b[hit] - a[hit])]]

        spans = table(lambda n: n.startswith("bench.")
                      and n != "bench.window")
        ops = table(lambda n: n.startswith("aten::"))
        out: Dict[str, float] = {}
        for a, b in gaps[:n_gaps]:
            mid = (a + b) / 2
            label = (innermost(spans, mid, "bench (harness)") + " | "
                     + innermost(ops, mid, "python"))
            out[label] = out.get(label, 0.0) + (b - a) / 1e6
        return out

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self._gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def recording_flash_calls(calls: list):
    """Record the shape of every attention forward the port dispatches
    (its ``flash_attention_fwd`` entry), for the kernels' rooflines; used
    in the traced run only."""
    from repro_torch.kernels.flash_attention import ops
    inner = ops.flash_attention_fwd

    def rec(q, k, v, *, causal=True, window=0, q_offset=0, scale=None):
        B, Sq, H, D = q.shape
        calls.append({"B": B, "Sq": Sq, "Skv": k.shape[1], "H": H,
                      "KV": k.shape[2], "D": D,
                      "causal": bool(causal) and q_offset == 0
                      and not window, "itemsize": q.element_size()})
        return inner(q, k, v, causal=causal, window=window,
                     q_offset=q_offset, scale=scale)

    ops.flash_attention_fwd = rec
    try:
        yield calls
    finally:
        ops.flash_attention_fwd = inner
