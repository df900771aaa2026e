"""Plain PyTorch RMSNorm: x * rsqrt(mean(x^2) + eps) * scale in fp32, cast
back to x's dtype."""
from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)
