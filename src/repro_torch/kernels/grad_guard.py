"""A CUDA kernel without a backward must not hand autograd an output that
silently has no gradient: its dispatch calls ``refuse_grad`` before the
launch, which raises when grad mode is on and an input needs a gradient.
The CPU path (plain PyTorch, differentiable by autograd) is not guarded.
"""
from __future__ import annotations

import torch

NO_REFERENCE_GRAD = "no gradient in the reference"


def refuse_grad(what: str, why: str, *tensors) -> None:
    """Raise ``NotImplementedError`` naming ``why`` (a ROADMAP item, or
    ``NO_REFERENCE_GRAD``) when a gradient would have to pass the kernel."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel has no backward ({why}); call it "
            "under torch.no_grad() or on inputs that need no gradient")
