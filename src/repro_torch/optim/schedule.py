"""Learning-rate schedules: ``fn(step) -> lr`` for a Python int step.

Evaluated in float32 as the reference's ``jnp`` math is (every constant
and every intermediate a float32, in the reference's order of
operations); the cosine is the float64 cosine rounded to float32, which
is what the reference's float32 cosine gives to within one ulp. The value
comes back as a Python float holding that float32 exactly, so
``AdamW.update`` multiplies float32 tensors by the same number.
"""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step) -> float:
        step = _f32(step)
        if step < warmup_steps:
            return float(_f32(peak_lr) * step / _f32(max(warmup_steps, 1)))
        prog = np.clip((step - _f32(warmup_steps))
                       / _f32(max(total_steps - warmup_steps, 1)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(np.cos(np.float64(_f32(np.pi) * prog)))
        return float(_f32(peak_lr) * (_f32(final_frac)
                                      + _f32((1 - final_frac) * 0.5)
                                      * (_f32(1.0) + cos)))
    return fn


def constant(lr: float):
    return lambda step: float(_f32(lr))


def linear_warmup(peak_lr: float, warmup_steps: int):
    def fn(step) -> float:
        step = _f32(step)
        return float(_f32(peak_lr) * min(_f32(1.0), step
                                         / _f32(max(warmup_steps, 1))))
    return fn
