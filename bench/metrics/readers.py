"""Readers shared by metrics of one kind in several kinds of cell: a
per-name file ``bench/metrics/<metric>.py`` takes one of these as its
``read``. Each returns None where its cell has nothing for it to read."""
from __future__ import annotations

from typing import Optional

from bench.metrics.yardstick import PEAK_FLOPS, roofline_share


def read_mfu(rec) -> Optional[float]:
    """The whole step's share of the card's peak, in %: the model FLOPs of
    the work the window completed, each at the peak of its type (float32
    outside the tensor cores, bfloat16 on them), over the time of that
    work."""
    if not rec["work_s"]:
        return None
    ideal = sum(f / PEAK_FLOPS[t] for t, f in rec["flops"].items())
    return 100.0 * ideal / rec["work_s"] if ideal else None


def read_idle_share(rec) -> Optional[float]:
    """The card's idle share of the traced window, in %: the time in which
    no operation ran on it (the union of the trace's device intervals is
    the busy time)."""
    tr = rec["trace"]
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def flash_roofline(rec, kernel: str, itemsize: int) -> Optional[float]:
    """A flash forward kernel's share of its roofline, in %: the sum of
    each recorded call's bound (``yardstick.flash_call_bound_s``) over the
    kernel's device time in the traced window."""
    tr = rec["trace"]
    if tr is None:
        return None
    return roofline_share(rec["flash_calls"], tr.kernel_time(kernel),
                          itemsize)


def read_flash_f32_roofline(rec) -> Optional[float]:
    return flash_roofline(rec, "flash_fwd_f32", 4)


def read_flash_bf16_roofline(rec) -> Optional[float]:
    return flash_roofline(rec, "flash_fwd_wgmma", 2)
