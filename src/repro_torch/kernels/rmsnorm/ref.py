"""Plain PyTorch RMSNorm, forward and backward: x * rsqrt(mean(x^2) + eps)
* scale in fp32, cast back to x's dtype, and its gradients (the autodiff
of the reference's ``layers.rmsnorm``)."""
from __future__ import annotations

from typing import Tuple

import torch


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def rmsnorm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-6,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's dtype) of ``rmsnorm_reference``
    for the cotangent ``dy``, in fp32 (``compute_dtype``: float64 gives a
    yardstick of the fp32 versions' own error): with r = rsqrt(mean(x^2) +
    eps), x^ = x r and g = dy, dx = r (g s - x^ mean(g s x^)) and dscale =
    sum over rows of g x^."""
    D = x.shape[-1]
    xf, g, s = (t.to(compute_dtype) for t in (x, dy, scale))
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    gs = g * s
    dx = r * (gs - xh * torch.mean(gs * xh, dim=-1, keepdim=True))
    ds = (g * xh).reshape(-1, D).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)
