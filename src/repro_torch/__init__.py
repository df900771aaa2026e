"""PyTorch + CUDA port of RECALL (embed -> int4 bank -> speculative query,
the IVF coarse filter, the write side, healing, training) and of the
reference's model zoo (the LM serving and training paths, dense and MoE;
the recsys and GNN families' steps), beside the JAX reference package
``repro``.

Subpackages mirror ``repro``'s names so each module's counterpart is easy to
find. Kernels are hand-written for Hopper (``kernels/*/csrc`` and the Triton
rmsnorm); every other op is plain PyTorch.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a caller asked for. Asking for CUDA where there is no
    card raises: the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return dev
