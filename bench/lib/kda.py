"""The yardstick of the Kimi-Linear cell (KDA beside NoPE MLA): the model
FLOPs of a prefill step, the operations and bytes of the KDA kernel's
work, and the readers of its roofline share and of the elementwise share.
``c`` is the configuration file's dict (HF key names). Kept beside the
benchmark, so that no change to the program moves it.
"""
from __future__ import annotations

from typing import Dict, Optional

from bench.lib import mla as Y
from bench.metrics.yardstick import (ELEMENTWISE, HBM_BYTES_PER_S,
                                     PEAK_FLOPS, kernel_class)
from bench.reference import kimi_linear as RK

KDA_KERNEL = "kda_"              # the KDA kernels' names hold it


def kda_layer_flops(c: Dict, T: int) -> float:
    """One KDA layer over T tokens: the q, k, v and o projections, the
    low-rank gates W_fa W_fb and W_ga W_gb, beta's projection, the three
    short convolutions (a multiply-add a tap and channel) and the
    recurrence at 6 dk dv a token and head (S^T k, the rank-one update,
    S^T q)."""
    la = c["linear_attn_config"]
    d, H, hd, r = (c["hidden_size"], la["num_heads"], la["head_dim"],
                   c["kda_gate_rank"])
    W = H * hd
    proj = 2.0 * T * (4 * d * W + 2 * (d * r + r * W) + d * H)
    conv = 2.0 * T * la["short_conv_kernel_size"] * 3 * W
    return proj + conv + 6.0 * T * H * hd * hd


def prefill_flops(c: Dict, B: int, S: int) -> float:
    """One prefill step of B causal prompts of S tokens through the layers
    run (``reference.kimi_linear.n_layers``): the KDA layers, the NoPE MLA
    layers (projections and the causal attention's live pairs, as
    ``bench/lib/mla.prefill_flops`` counts them), the dense layers'
    SwiGLU, the MoE layers' router, routed experts (top-k a token) and
    shared experts, and the exit head on the pooled states (no logits)."""
    d, H, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dqk, dv = Y.head_dims(c)
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    T = B * S
    L = RK.n_layers(c)
    n_kda = len(RK.kda_layers(c))
    mla = (2.0 * T * (d * H * dqk + d * (r + rope) + r * H * (nope + dv)
                      + H * dv * d)
           + 2.0 * B * H * (dqk + dv) * S * (S + 1) / 2)
    k = c["first_k_dense_replace"]
    E, K, F = (c["num_experts"], c["num_experts_per_token"],
               c["moe_intermediate_size"])
    dense = 2.0 * T * 3 * d * c["intermediate_size"]
    moe = 2.0 * T * (d * E + K * 3 * d * F
                     + c["num_shared_experts"] * 3 * d * F)
    return (n_kda * kda_layer_flops(c, T) + (L - n_kda) * mla + k * dense
            + (L - k) * moe
            + 2.0 * len(RK.exit_layers(c)) * B * d * c["embed_dim"])


def kda_bound_s(c: Dict, tokens: int, seq: int) -> float:
    """The least time of the KDA kernels' work over ``tokens`` token-heads
    (the program's counter) of sequences ``seq`` long: 6 dk dv operations a
    token-head at the bf16 peak, or its bytes at HBM speed (q, k, v and o
    at 2 bytes, g at 4 bytes a channel, beta at 4 bytes a token-head, and
    a final fp32 state a sequence and head)."""
    hd = c["linear_attn_config"]["head_dim"]
    ops = 6.0 * tokens * hd * hd
    n_bytes = tokens * (4 * hd * 2 + hd * 4 + 4) + tokens / seq * hd * hd * 4
    return max(ops / PEAK_FLOPS["bf16"], n_bytes / HBM_BYTES_PER_S)


def read_kda_roofline(rec) -> Optional[float]:
    """The KDA kernel's share of its roofline, in %: ``kda_bound_s`` of the
    window's ``kda_tokens`` over the device time of the kernels whose names
    hold ``kda_``; None where the program counted no KDA token."""
    tr = rec["trace"]
    n = rec["counters"].get("kda_tokens")
    if tr is None or not n:
        return None
    t = tr.kernel_time(KDA_KERNEL)
    return (100.0 * kda_bound_s(rec["config"], n, rec["traffic"]["seq"]) / t
            if t else None)


def read_elementwise_share(rec) -> Optional[float]:
    """The share of the card's busy time in the traced window spent in
    elementwise work (casts, copies, the KDA layer's convolutions, gates
    and gated norm, the MoE layer's row shuffles), in %: the kernels
    ``yardstick.kernel_class`` names no class for, less the
    ``flash_fwd_mla`` and KDA kernels, which it knows by no name either."""
    tr = rec["trace"]
    if tr is None or not tr.busy_s:
        return None
    s = sum(t for n, t in tr.kernel_s.items()
            if kernel_class(n) == ELEMENTWISE and Y.FLASH_KERNEL not in n
            and KDA_KERNEL not in n)
    return 100.0 * s / tr.busy_s
