"""AdamW with decoupled weight decay and global-norm clipping.

Functional, on nested dicts of tensors: ``update`` returns new params and a
new state and leaves its inputs untouched, in the reference's update order
(clip by the global norm, moments, bias correction, decay on the old
params). ``m``/``v`` stay in float32 whatever the params' dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch


def _map(fn, *trees):
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for k in tree for x in _leaves(tree[k])]


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(step=0, m=_map(zeros, params), v=_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, dict]:
        """Returns (new_params, new_state, metrics)."""
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp_min(gnorm, 1e-9),
                                max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        step = state.step + 1
        # bias corrections in fp32, as the reference computes them
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        b1c = (1.0 - f32(self.b1) ** step).to(gnorm.device)
        b2c = (1.0 - f32(self.b2) ** step).to(gnorm.device)
        lr = self.lr(step) if callable(self.lr) else self.lr

        def upd(p, g, m, v):
            g = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * torch.square(g)
            mh, vh = m / b1c, v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = _map(upd, params, grads, state.m, state.v)
        new_params = _pick(out, 0)
        new_m, new_v = _pick(out, 1), _pick(out, 2)
        return new_params, AdamWState(step, new_m, new_v), {
            "grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    if isinstance(tree, tuple):
        return tree[i]
    return {k: _pick(v, i) for k, v in tree.items()}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(leaves))
