"""The benchmark's yardstick: the H100's published peaks, the kernel
classes of a device trace, each kernel's operations and bytes, and the
model FLOPs behind the ``mfu.*`` metrics. Kept here, beside the metric
readers, so that no change to the program moves it.
"""
from __future__ import annotations

import subprocess
from typing import Dict, Iterable, Optional

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
PEAK_FLOPS = {"bf16": 989e12,   # tensor cores
              "fp32": 67e12}    # outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ('' if it
    cannot): a card set below 700 W runs slower than the peaks assume."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# kernel name fragment -> class (first match wins)
_CLASSES = (("flash_fwd_wgmma", "attention (flash wgmma kernel, bf16)"),
            ("flash_fwd_f32", "attention (flash FMA kernel, f32)"),
            ("decode_split", "decode attention (CUDA kernel, split pass)"),
            ("decode_merge", "decode attention (CUDA kernel, merge pass)"),
            ("moe_gemm_wgmma", "grouped expert GEMM (wgmma kernel)"),
            ("moe_gemm_kernel", "grouped expert GEMM (mma.sync kernel)"),
            ("int4_quant", "int4 quantize (cache kernel)"),
            ("int4_dequant", "int4 dequantize (cache kernel)"),
            ("Memcpy DtoH", "copies device to host"),
            ("Memcpy HtoD", "copies host to device"),
            ("topk_int4_gather", "gathered int4 scan (top-k kernel)"),
            ("topk_int4", "int4 scan (top-k kernel)"),
            ("topk_dense", "dense scan (top-k kernel)"),
            ("topk_pass2", "top-k merge (pass 2)"),
            ("rmsnorm", "rmsnorm (Triton kernel)"),
            ("gemm", "matmul (cuBLAS)"), ("sm90_", "matmul (cuBLAS)"),
            ("nvjet", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"))
ELEMENTWISE = "other (elementwise, copies, sort)"


def kernel_class(name: str) -> str:
    for key, cls in _CLASSES:
        if key in name:
            return cls
    return ELEMENTWISE


# -- kernels: operations and bytes of one call ------------------------------

def flash_call_bound_s(B: int, Sq: int, Skv: int, H: int, KV: int, D: int,
                       *, causal: bool, itemsize: int) -> float:
    """The least time of one attention forward: the larger of its
    operations (4·B·H·D·pairs: QK^T and PV, pairs the live (query, key)
    pairs: Sq·Skv, or S(S+1)/2 causal) at the peak of its type and its
    bytes (q and o once, k and v once) at HBM speed."""
    pairs = Sq * (Sq + 1) / 2 if causal and Sq == Skv else Sq * Skv
    ops = 4.0 * B * H * D * pairs
    peak = PEAK_FLOPS["bf16" if itemsize == 2 else "fp32"]
    n_bytes = (2 * B * Sq * H * D + 2 * B * Skv * KV * D) * itemsize
    return max(ops / peak, n_bytes / HBM_BYTES_PER_S)


def roofline_share(calls: Iterable[dict], kernel_s: Optional[float],
                   itemsize: int) -> Optional[float]:
    """Σ bound / Σ kernel time, in %, over the recorded calls of one
    dtype; None where no such call or no kernel time was seen."""
    bound = sum(flash_call_bound_s(c["B"], c["Sq"], c["Skv"], c["H"],
                                   c["KV"], c["D"], causal=c["causal"],
                                   itemsize=itemsize)
                for c in calls if c["itemsize"] == itemsize)
    if not bound or not kernel_s:
        return None
    return 100.0 * bound / kernel_s


# -- model FLOPs --------------------------------------------------------------

def encoder_layer_flops(S: int, d: int, d_ff: int) -> float:
    """One bidirectional layer over S tokens: QKV and O projections, the
    SwiGLU's three products, QK^T and PV."""
    return 2.0 * S * 4 * d * d + 2.0 * S * 3 * d * d_ff + 4.0 * S * S * d


def decoder_layer_flops(B: int, S: int, d: int, d_ff: int, H: int, KV: int,
                        hd: int) -> float:
    """One causal GQA layer over B prompts of S tokens: projections, SwiGLU
    and the causal attention's live pairs."""
    proj = 2.0 * B * S * (d * H * hd + 2 * d * KV * hd + H * hd * d)
    mlp = 2.0 * B * S * 3 * d * d_ff
    attn = 4.0 * B * H * hd * S * (S + 1) / 2
    return proj + mlp + attn


def tower_sizes(cfg: Dict, modality: str) -> Dict:
    for t in cfg["towers"]:
        if t["modality"] == modality:
            return t
    raise KeyError(modality)


def photo_flops(cfg: Dict, layers_run: float, n: int) -> float:
    """n photos' frontend and ``layers_run`` vision layers in all."""
    t = tower_sizes(cfg, "vision")
    S = t["n_tokens"] + 1
    return (2.0 * n * t["n_tokens"] * t["d_input"] * t["d_model"]
            + layers_run * encoder_layer_flops(S, t["d_model"], t["d_ff"])
            + 2.0 * n * t["d_model"] * cfg["embed_dim"])


def prefill_flops(cfg: Dict, B: int, S: int) -> float:
    """One prefill step: every layer, and the exit head on the pooled
    states (no logits)."""
    layer = decoder_layer_flops(B, S, cfg["hidden_size"],
                                cfg["intermediate_size"],
                                cfg["num_attention_heads"],
                                cfg["num_key_value_heads"], cfg["head_dim"])
    n_exits = len(range(cfg["exit_interval"], cfg["num_hidden_layers"] + 1,
                        cfg["exit_interval"]))
    return (cfg["num_hidden_layers"] * layer
            + 2.0 * n_exits * B * cfg["hidden_size"] * cfg["embed_dim"])
