"""AdamW with decoupled weight decay, global-norm clipping and gradient
accumulation.

Functional, on nested dicts of tensors: ``update`` returns new params and a
new state and leaves its inputs untouched, in the reference's update order
(mask the grads, clip by the global norm, moments, bias correction, decay
on the old params). ``m``/``v`` stay in float32 whatever the params' dtype.
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
    def update(self, grads, state: AdamWState, params, grad_mask=None, *,
               donate: bool = False) -> Tuple[Any, AdamWState, dict]:
        """Returns (new_params, new_state, metrics). ``grad_mask`` (the
        grads' structure, 0/1 leaves that broadcast against them) multiplies
        the grads before the global norm: P-LoRA healing freezes the masked
        layers' grads this way (their moments still decay and move them).
        ``donate`` writes the new values into ``params`` and the state's
        moments, leaf by leaf (the reference's ``donate_argnums``), so the
        update holds one leaf's temporaries rather than a second copy of
        params and moments; the values are the same bits."""
        if grad_mask is not None:
            grads = _map(lambda g, k: g * k, grads, grad_mask)
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

        def upd_(p, g, m, v):
            new = upd(p, g, m, v)
            for old, x in zip((p, m, v), new):
                old.copy_(x)
            return p, m, v

        out = _map(upd_ if donate else upd, params, grads, state.m, state.v)
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


def value_and_grad(loss_fn, params, batch):
    """(loss, grads in the params' structure and dtypes) of
    ``loss_fn(params, batch)``, a scalar; a leaf the loss does not reach
    gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = _map(lambda p: p.detach().requires_grad_(True), params)
    flat = _leaves(leaves)
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)])
    return loss.detach(), _map(lambda _: next(it), params)


def accumulate_grads(loss_fn, params, batches, *, microbatches: int):
    """Gradient accumulation over ``microbatches`` equal slices of
    ``batches`` (a tensor or a dict of tensors, sliced on the leading axis;
    a remainder past ``microbatches`` slices is dropped, as the reference
    drops it). ``loss_fn(params, batch)`` returns a scalar. Returns
    (mean_loss, mean_grads), both float32."""
    n = _leaves(batches)[0].shape[0] // microbatches
    loss_acc = None
    grads_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in _leaves(params)]
    for i in range(microbatches):
        mb = _map(lambda x: x[i * n:(i + 1) * n], batches)
        leaves = _map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, mb)
        grads = torch.autograd.grad(loss, _leaves(leaves), allow_unused=True)
        loss = loss.detach().float()
        loss_acc = loss if loss_acc is None else loss_acc + loss
        grads_acc = [a if g is None else a + g.float()
                     for a, g in zip(grads_acc, grads)]
    inv = 1.0 / microbatches
    it = iter(grads_acc)
    return loss_acc * inv, _map(lambda _: next(it) * inv, params)
