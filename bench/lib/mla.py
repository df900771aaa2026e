"""The yardstick of the MLA cells (Moonlight-16B-A3B, DeepSeek-V3's
block): the model FLOPs of a prefill step, the operations and bytes of
one call of the MLA flash forward and of the expert GEMMs, and the
readers of their roofline shares and of the elementwise share. ``c`` is
the configuration file's dict (HF key names). Kept beside the benchmark,
so that no change to the program moves it.
"""
from __future__ import annotations

from typing import Dict, Optional

from bench.metrics.yardstick import (ELEMENTWISE, HBM_BYTES_PER_S,
                                     PEAK_FLOPS, kernel_class)
from bench.reference.moonlight import exit_layers

FLASH_KERNEL = "flash_fwd_mla"   # the MLA forward's kernel name
GEMM_KERNEL = "moe_gemm"         # the grouped expert GEMM's kernels


def head_dims(c: Dict) -> tuple:
    """(q/k head dim, v head dim)."""
    return c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]


def prefill_flops(c: Dict, B: int, S: int) -> float:
    """One prefill step of B causal prompts of S tokens: every layer's
    MLA projections (q, the latent down- and up-projections, o), the
    causal attention's live pairs at q/k and v widths, the dense layers'
    SwiGLU, the MoE layers' router, routed experts (top-k of them a
    token) and shared experts, and the exit head on the pooled states (no
    logits)."""
    d, H, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    dqk, dv = head_dims(c)
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    T = B * S
    proj = 2.0 * T * (d * H * dqk + d * (r + rope) + r * H * (nope + dv)
                      + H * dv * d)
    attn = 2.0 * B * H * (dqk + dv) * S * (S + 1) / 2
    k, L = c["first_k_dense_replace"], c["num_hidden_layers"]
    E, K, F = (c["n_routed_experts"], c["num_experts_per_tok"],
               c["moe_intermediate_size"])
    dense = 2.0 * T * 3 * d * c["intermediate_size"]
    moe = 2.0 * T * (d * E + K * 3 * d * F + c["n_shared_experts"] * 3 * d * F)
    return (L * (proj + attn) + k * dense + (L - k) * moe
            + 2.0 * len(exit_layers(c)) * B * d * c["embed_dim"])


def flash_call_bound_s(call: Dict, dv: int) -> float:
    """The least time of one MLA flash forward: 2·B·H·pairs·(Dqk + Dv)
    operations at the bf16 peak, or q, k, v and o once each at HBM speed
    (pairs: S(S+1)/2 causal, else Sq·Skv)."""
    B, Sq, Skv, H, KV, D = (call[x] for x in ("B", "Sq", "Skv", "H", "KV",
                                              "D"))
    pairs = Sq * (Sq + 1) / 2 if call["causal"] and Sq == Skv else Sq * Skv
    ops = 2.0 * B * H * pairs * (D + dv)
    n_bytes = (B * Sq * H * (D + dv) + B * Skv * KV * (D + dv)) \
        * call["itemsize"]
    return max(ops / PEAK_FLOPS["bf16"], n_bytes / HBM_BYTES_PER_S)


def read_flash_roofline(rec) -> Optional[float]:
    """The MLA flash forward's share of its roofline, in %: Σ the bounds of
    the recorded calls at the configuration's q/k head dim over the
    ``flash_fwd_mla`` kernels' device time."""
    tr, c = rec["trace"], rec["config"]
    if tr is None:
        return None
    dqk, dv = head_dims(c)
    bound = sum(flash_call_bound_s(x, dv) for x in rec["flash_calls"]
                if x["D"] == dqk and x["itemsize"] == 2)
    t = tr.kernel_time(FLASH_KERNEL)
    return 100.0 * bound / t if bound and t else None


def read_gemm_roofline(rec) -> Optional[float]:
    """The expert GEMMs' share of their roofline, in %: 6 · assignments ·
    d · F operations (gate, up and down of each routed (token, expert)
    pair; the program's counter) at the bf16 peak over the ``moe_gemm``
    kernels' device time."""
    tr, c = rec["trace"], rec["config"]
    n = rec["counters"].get("assignments")
    if tr is None or not n:
        return None
    ops = 6.0 * n * c["hidden_size"] * c["moe_intermediate_size"]
    t = tr.kernel_time(GEMM_KERNEL)
    return 100.0 * ops / PEAK_FLOPS["bf16"] / t if t else None


def read_elementwise_share(rec) -> Optional[float]:
    """The share of the card's busy time in the traced window spent in
    elementwise work (casts, copies, RoPE, the MoE layer's row shuffles and
    weighted sum), in %: the kernels ``yardstick.kernel_class`` names no
    class for, less the ``flash_fwd_mla`` kernels, which it knows by no
    name either."""
    tr = rec["trace"]
    if tr is None or not tr.busy_s:
        return None
    s = sum(t for n, t in tr.kernel_s.items()
            if kernel_class(n) == ELEMENTWISE and FLASH_KERNEL not in n)
    return 100.0 * s / tr.busy_s
