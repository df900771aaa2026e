"""The share of the card's busy time in the traced window spent in
kernels of no named class (elementwise ops, casts, copies on the card),
in %."""
from bench.metrics.yardstick import ELEMENTWISE


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.busy_s:
        return None
    return 100.0 * tr.class_s().get(ELEMENTWISE, 0.0) / tr.busy_s
