"""Weights made by the benchmark from ``--seed``, in the port's parameter
layout, on the device, in the type they are served in.

``make_params`` walks a schema (nested dicts of the port's ``ParamDef``:
shape, logical axes, init kind) in sorted key order and fills every leaf
from ONE normal draw of the total size, each leaf a view of that buffer
scaled in place: projections at 1/sqrt(their input width) (the input
width read from the logical axes: a weight's last axis is its output, or
its last two when they are (heads, head_dim)), embedding tables and
learned positions at their init scale, RMSNorm scales at 1 + 0.1 N(0, 1)
and biases at 0.02 N(0, 1), so that every term of the forward carries
weight. The same seed gives the same bits on the same device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

_HEAD_AXES = ("heads", "kv_heads")


def _leaves(schema, path=()) -> List[Tuple[tuple, Any]]:
    if hasattr(schema, "shape") and hasattr(schema, "axes"):
        return [(path, schema)]
    out = []
    for k in sorted(schema):
        out += _leaves(schema[k], path + (k,))
    return out


def _std_and_shift(d) -> Tuple[float, float]:
    """(std, mean) of a leaf's draw."""
    if d.init == "ones":
        return 0.1, 1.0
    if d.init == "zeros":
        return 0.02, 0.0
    if d.init == "embed":
        return d.scale * 0.02, 0.0
    if d.init == "normal":
        return d.scale, 0.0
    if d.init == "fan_in":
        dims = [n for n, a in zip(d.shape, d.axes) if a != "layer"]
        axes = [a for a in d.axes if a != "layer"]
        n_out = (dims[-1] * dims[-2] if len(dims) >= 3
                 and axes[-2] in _HEAD_AXES else dims[-1])
        fan_in = max(math.prod(dims) // n_out, 1)
        return d.scale / math.sqrt(fan_in), 0.0
    raise ValueError(f"init {d.init!r}")


def make_params(schema, *, seed: int, dtype: torch.dtype, device) -> Dict:
    leaves = _leaves(schema)
    total = sum(math.prod(d.shape) for _, d in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: Dict = {}
    off = 0
    for path, d in leaves:
        n = math.prod(d.shape)
        t = flat[off:off + n].view(d.shape)
        off += n
        std, shift = _std_and_shift(d)
        t.mul_(std)
        if shift:
            t.add_(shift)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def n_elements(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(n_elements(v) for v in params.values())
