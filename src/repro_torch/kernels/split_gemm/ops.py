"""Dispatch of the split GEMMs (fp32 activations times bf16 weights at an
fp32 product's precision, on the tensor cores): a CPU tensor takes the
plain versions (``ref.py``), a CUDA tensor launches the kernels
(``kernel.py``) or raises. ``launches`` counts kernel launches and
``launches_by_kernel`` splits them into ``gate_up`` and ``down``.

``takes`` is the rule by which ``models/layers.swiglu`` takes this path:
float32 activations, bfloat16 weights, no gradient recorded through them
(the kernels have no backward) and widths TMA takes. The rule reads only
the inputs, so a caller whose dtypes differ (the bf16 towers and LMs) or
who trains keeps the plain products.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.split_gemm import ref
from repro_torch.kernels.split_gemm.kernel import takes as _widths_fit

launches = 0
launches_by_kernel: Dict[str, int] = {}


def takes(x: torch.Tensor, *ws: torch.Tensor) -> bool:
    """Whether ``x @ w`` for each of ``ws`` may take the split path."""
    if x.dtype != torch.float32 or \
            any(w.dtype != torch.bfloat16 for w in ws):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ws)):
        return False
    return x.device.type in ("cpu", "cuda") and \
        all(_widths_fit(*w.shape[-2:]) for w in ws)


def _launched(name: str) -> None:
    global launches
    launches += 1
    launches_by_kernel[name] = launches_by_kernel.get(name, 0) + 1


def swiglu_gate_up(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor) -> torch.Tensor:
    """h (M, d_ff) fp32 = SiLU(x @ w_gate) * (x @ w_up); x (M, d) fp32,
    the weights (d, d_ff) bf16."""
    if x.device.type == "cpu":
        return ref.swiglu_gate_up(x, w_gate, w_up)
    if x.device.type != "cuda":
        raise ValueError(f"split_gemm: no kernel for {x.device}")
    from repro_torch.kernels.split_gemm.kernel import swiglu_gate_up_cuda
    out = swiglu_gate_up_cuda(x, w_gate, w_up)
    _launched("gate_up")
    return out


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (M, N) fp32 = x (M, K) fp32 @ w (K, N) bf16 (the SwiGLU's down
    projection)."""
    if x.device.type == "cpu":
        return ref.matmul(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"split_gemm: no kernel for {x.device}")
    from repro_torch.kernels.split_gemm.kernel import matmul_cuda
    out = matmul_cuda(x, w)
    _launched("down")
    return out
