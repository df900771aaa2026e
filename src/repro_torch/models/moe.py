"""Mixture-of-Experts: top-k router + GShard group-wise capacity semantics,
with the expert FFN on the grouped expert GEMM; and DeepSeek-V3's layer
(``moe_apply_dropless``: a sigmoid router with a bias that chooses but
does not weigh, no capacity and no drop, the shared experts beside).

The reference dispatches each group's (batch row's) tokens into a
(B, E, C, d) capacity buffer and runs the experts as dense einsums. The
port computes the same function without the buffer: every one of the
B * S * K assignments goes through ``kernels.moe_gemm`` (gate, up and down
on one sort/pad plan), and the assignments the reference drops
(position-in-expert >= C) are zeroed at the combine, as the reference's
``jnp.where(keep, y_tok, 0)`` does. No data-dependent shape reaches the
host. The gradient runs the grouped GEMM's backward on the same plan and
uses no atomics: the same bits twice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, RouterConfig
from repro_torch.kernels.moe_gemm import ops as gemm
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span

# counters of the dropless layer: calls, routed (token, expert) assignments
# and the largest load one expert took in one call (a device scalar, read
# by ``read_counters``: the layer never waits for the host)
counters: Dict[str, int] = {"calls": 0, "assignments": 0}
_max_load: Dict[torch.device, torch.Tensor] = {}


def read_counters() -> Dict[str, int]:
    """{"calls", "assignments", "max_load"} since ``reset_counters``."""
    loads = [int(t.item()) for t in _max_load.values()]
    return dict(counters, max_load=max(loads, default=0))


def reset_counters() -> None:
    counters.update(calls=0, assignments=0)
    _max_load.clear()


def moe_schema(d_model: int, moe: MoEConfig,
               layer_dims: Tuple[int, ...] = (),
               router: Optional[RouterConfig] = None) -> Schema:
    Ld = layer_dims
    la = tuple("layer" for _ in Ld)
    E, Fe = moe.n_experts, moe.d_ff_expert
    s: Schema = {
        "router": ParamDef(Ld + (d_model, E), la + ("embed", "expert"), "fan_in"),
        "w_gate": ParamDef(Ld + (E, d_model, Fe), la + ("expert", "embed", "mlp"), "fan_in"),
        "w_up": ParamDef(Ld + (E, d_model, Fe), la + ("expert", "embed", "mlp"), "fan_in"),
        "w_down": ParamDef(Ld + (E, Fe, d_model), la + ("expert", "mlp", "embed"), "fan_in"),
    }
    if moe.n_shared_experts:
        s["shared"] = L.swiglu_schema(d_model, Fe * moe.n_shared_experts,
                                      layer_dims=Ld)
    if router is not None:   # e_score_correction_bias
        s["bias"] = ParamDef(Ld + (E,), la + ("expert",), "zeros")
    return s


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(np.ceil(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts))
    return max(8, int(np.ceil(c / 8)) * 8)  # pad to lane multiple


def _route(p: Schema, x: torch.Tensor, moe: MoEConfig):
    """fp32 softmax router, top-k, renormalised: (probs, top_p, top_i)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, moe.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def expert_ffn_sorted(p: Schema, x: torch.Tensor, expert_ids: torch.Tensor,
                      top_k: int) -> Tuple[torch.Tensor, gemm.Plan]:
    """(ys, plan): ys (T_pad, d) the outputs of assignment a = token
    a // top_k of x (T, d) through expert ``expert_ids[a]``'s SwiGLU, at
    row ``plan.slot_of[a]`` of the plan's sorted layout: gate and up, the
    gate's SiLU in fp32 cast back, times up, then down. Where ``rows_take``
    x (on the card, no gradient recorded) the rows are dispatched in one
    launch, else by ``scatter_rows``; where ``swiglu_takes`` the sorted rows
    the first three steps are one fused launch, else three grouped GEMMs'
    steps."""
    E = p["w_gate"].shape[0]
    bt = gemm.block_t_for(expert_ids.shape[0], E)
    plan = gemm.plan(expert_ids, E, bt)
    xs = (gemm.dispatch_rows(x, plan, top_k) if gemm.rows_take(x)
          else gemm.scatter_rows(x, plan, top_k))
    w_gate, w_up, w_down = (p[k].to(x.dtype)
                            for k in ("w_gate", "w_up", "w_down"))

    def grouped(h, w):
        return gemm.moe_gemm_sorted(h, plan.block_expert, w, bt, plan.used,
                                    plan.ends)

    if gemm.swiglu_takes(xs, w_gate, w_up, bt):
        h = gemm.moe_gemm_sorted_swiglu(xs, plan.block_expert, w_gate, w_up,
                                        bt, plan.used)
    else:
        g = grouped(xs, w_gate)
        u = grouped(xs, w_up)
        h = F.silu(g.float()).to(x.dtype) * u
    return grouped(h, w_down), plan


def expert_ffn(p: Schema, x: torch.Tensor, expert_ids: torch.Tensor,
               top_k: int) -> torch.Tensor:
    """(T * K, d) outputs of assignment a = token a // top_k of x (T, d)
    through expert ``expert_ids[a]``'s SwiGLU (``expert_ffn_sorted``), in
    assignment order."""
    ys, plan = expert_ffn_sorted(p, x, expert_ids, top_k)
    return gemm.gather_rows(ys, plan)


def moe_apply(p: Schema, x: torch.Tensor,
              moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Group-wise (per batch row) capacity,
    as the reference's ``moe_apply``."""
    B, S, d = x.shape
    E, K = moe.n_experts, moe.top_k
    C = capacity(S, moe)  # per-group capacity

    probs, top_p, top_i = _route(p, x, moe)            # (B, S, E), (B, S, K)

    experts = torch.arange(E, device=x.device)
    # Switch-style load-balancing auxiliary loss (per group, then averaged)
    frac_tokens = (top_i[..., 0, None] == experts).float().mean(1)  # (B, E)
    mean_probs = probs.mean(1)                                     # (B, E)
    aux = moe.router_aux_coef * E * torch.mean(
        torch.sum(frac_tokens * mean_probs, -1))

    # position-in-expert via a per-group cumsum over (token-major)
    # assignments; the reference drops an assignment at pos >= C
    flat_e = top_i.reshape(B, S * K)
    onehot = (flat_e[..., None] == experts).to(torch.int32)        # (B, SK, E)
    pos = torch.sum((torch.cumsum(onehot, 1, dtype=torch.int32) - 1) * onehot,
                    -1)
    keep = pos < C

    y_tok = expert_ffn(p, x.reshape(B * S, d), flat_e.reshape(-1), K)
    y_tok = torch.where(keep.reshape(-1, 1), y_tok, torch.zeros_like(y_tok))
    y = torch.sum(y_tok.reshape(B, S, K, d)
                  * top_p.reshape(B, S, K, 1).to(x.dtype), dim=2)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], x)
    return y, aux


def moe_apply_dense(p: Schema, x: torch.Tensor,
                    moe: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle path: run every expert densely, weight by router (tests
    only)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs, top_p, top_i = _route(p, xt, moe)
    gate = torch.zeros_like(probs).scatter(1, top_i, top_p)
    g = torch.einsum("td,edf->tef", xt, p["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", xt, p["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    out = torch.einsum("tef,efd->ted", h, p["w_down"].to(x.dtype))
    y = torch.einsum("ted,te->td", out.float(), gate).to(x.dtype)
    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + L.swiglu(p["shared"], x)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def route_sigmoid(p: Schema, x: torch.Tensor, moe: MoEConfig,
                  router: RouterConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router on x (T, d): (top_i (T, K) int64, weights
    (T, K) f32). Scores sigmoid(x W_r) in fp32; the top-k of scores + bias;
    weights the unbiased scores of the chosen,
    renormalised when ``norm_topk_prob``, times the scaling factor."""
    if router.n_group != 1 or router.topk_group != 1:
        raise NotImplementedError("group-limited routing (n_group > 1)")
    scores = torch.sigmoid(x.float() @ p["router"].float())
    choice = scores + p["bias"].float()
    top_i = torch.topk(choice, moe.top_k, dim=-1).indices
    w = torch.gather(scores, -1, top_i)
    if router.norm_topk_prob and moe.top_k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return top_i, w * router.routed_scaling_factor


def moe_apply_dropless(p: Schema, x: torch.Tensor, moe: MoEConfig,
                       router: RouterConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux 0): every token through its top-k experts
    on the grouped GEMMs (no capacity, nothing dropped), the k outputs
    summed by their weights (weights rounded to x's dtype), then the shared
    experts' SwiGLU added. Where ``rows_take`` the sorted outputs and the
    weights (on the card, no gradient recorded) the sum reads each token's
    k sorted rows in one launch (``combine_rows``), else the rows are
    gathered and summed in one batched product."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    with span("moe.route"):
        top_i, w = route_sigmoid(p, x2, moe, router)
        load = torch.zeros(moe.n_experts, dtype=torch.int64,
                           device=x.device).index_add_(
            0, top_i.reshape(-1), torch.ones_like(top_i.reshape(-1)))
        acc = _max_load.get(x.device)
        _max_load[x.device] = (load.max() if acc is None
                               else torch.maximum(acc, load.max()))
    counters["calls"] += 1
    counters["assignments"] += top_i.numel()
    with span("moe.experts"):
        ys, plan = expert_ffn_sorted(p, x2, top_i.reshape(-1), moe.top_k)
        if gemm.rows_take(ys, w):
            y = gemm.combine_rows(ys, plan, w)
        else:
            y_tok = gemm.gather_rows(ys, plan)
            y = torch.bmm(w.to(x.dtype)[:, None, :],
                          y_tok.view(B * S, moe.top_k, d))[:, 0]
    if "shared" in p:
        with span("moe.shared"):
            y = y + L.swiglu(p["shared"], x2)
    return y.view(B, S, d), torch.zeros((), dtype=torch.float32,
                                        device=x.device)
