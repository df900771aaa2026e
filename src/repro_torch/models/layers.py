"""Foundational layers: schema-driven params, RMSNorm, MLPs, losses.

Parameters are nested dicts of tensors built from a *schema* (nested dicts
of ``ParamDef``), the same structure as the reference's pytrees, so
``models/convert.py`` can carry JAX parameters across leaf by leaf.
RMSNorm goes through the kernel dispatch (Triton on CUDA, the plain version
on the CPU); every other op here is plain PyTorch, the P-LoRA delta
(``lora_delta``) and the recsys blocks' attention (``multihead_attention``,
whose head dims of 4 and 50 the flash kernel does not take) included.
Gathers clamp their ids and scatters (``segment_sum``) drop out-of-range
ids, as the reference's ``mode="clip"`` takes and ``segment_sum`` do; both
sum their gradients in a fixed order (``index_put_(accumulate=True)``
sorts the ids), so a step gives the same bits twice on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.split_gemm import ops as split_gemm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


# ---------------------------------------------------------------------------
# Schema-driven parameters
# ---------------------------------------------------------------------------


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | fan_in
    scale: float = 1.0


Schema = Dict[str, Any]  # nested dict of ParamDef


def _init_leaf(gen: torch.Generator, d: ParamDef, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "normal":
        std = d.scale
    elif d.init == "embed":
        std = d.scale * 0.02
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(fan_in)
    else:
        raise ValueError(d.init)
    x = torch.randn(d.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def init_params(gen: torch.Generator, schema: Schema, dtype=torch.float32,
                device="cuda"):
    """Initialize a nested param dict from a schema (keys in sorted order,
    one draw per leaf from ``gen``, which must live on ``device``)."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    return _schema_map(lambda d: _init_leaf(gen, d, dtype, device), schema)


def _schema_map(fn, schema: Schema):
    """``fn`` over a schema's ParamDefs, keys in sorted order."""
    if isinstance(schema, ParamDef):
        return fn(schema)
    return {k: _schema_map(fn, schema[k]) for k in sorted(schema)}


def param_specs(schema: Schema):
    """Logical-axes tree matching :func:`init_params` output structure."""
    return _schema_map(lambda d: d.axes, schema)


def abstract_params(schema: Schema, dtype=torch.float32):
    """The params' tree on the ``meta`` device: shapes and dtypes with no
    storage (the dry run's abstract arguments)."""
    dtype = torch_dtype(dtype)
    return _schema_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                             device="meta"), schema)


def count_params(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(count_params(v) for v in params.values())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_schema(d: int, layer_dims: Tuple[int, ...] = ()) -> ParamDef:
    axes = tuple("layer" for _ in layer_dims) + ("embed",)
    return ParamDef(layer_dims + (d,), axes, "ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_op(x, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (the population variance, as ``jnp.var``), cast
    back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. The
    rotation runs in fp32 and the result is cast back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs     # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]             # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections / MLPs (the attention apply functions live in
# models/transformer.py)
# ---------------------------------------------------------------------------


def attn_schema(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                qkv_bias: bool, layer_dims: Tuple[int, ...] = ()) -> Schema:
    L = layer_dims
    la = tuple("layer" for _ in L)
    s: Schema = {
        "wq": ParamDef(L + (d_model, n_heads, head_dim), la + ("embed", "heads", "head_dim"), "fan_in"),
        "wk": ParamDef(L + (d_model, n_kv, head_dim), la + ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wv": ParamDef(L + (d_model, n_kv, head_dim), la + ("embed", "kv_heads", "head_dim"), "fan_in"),
        "wo": ParamDef(L + (n_heads, head_dim, d_model), la + ("heads", "head_dim", "embed"), "fan_in"),
    }
    if qkv_bias:
        s["bq"] = ParamDef(L + (n_heads, head_dim), la + ("heads", "head_dim"), "zeros")
        s["bk"] = ParamDef(L + (n_kv, head_dim), la + ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamDef(L + (n_kv, head_dim), la + ("kv_heads", "head_dim"), "zeros")
    return s


NEG_INF = -1e30


def attention_scores_mask(q_len: int, kv_len: int, *, causal: bool,
                          window: int = 0, q_offset: int = 0,
                          device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; True = attend."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window and window > 0:
        mask &= kj > (qi - window)
    return mask


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, plain: fp32 scores, the masked ones set to
    -1e30, softmax, fp32 P·V, cast back to q's dtype (the reference's
    ``layers.multihead_attention``). q (B, Sq, H, D); k, v (B, Skv, KV, D)
    with H % KV == 0; ``mask`` (Sq, Skv), (B, Sq, Skv) or (B, H, Sq, Skv),
    True = attend."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 2:
            m = mask[None, None, None]
        elif mask.ndim == 3:  # (B, Sq, Skv)
            m = mask[:, None, None]
        else:  # (B, H, Sq, Skv)
            m = mask.reshape(B, KV, G, Sq, -1)
        scores = torch.where(m, scores, torch.full((), NEG_INF,
                                                   device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attn_project_qkv(p: Schema, x: torch.Tensor, *, rope_theta: float,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d_model) -> q (B,S,H,D), k/v (B,S,KV,D), biases added and
    RoPE applied when ``rope_theta`` > 0."""
    B, S, d = x.shape
    out = []
    for name in ("wq", "wk", "wv"):
        w = p[name].to(x.dtype)                          # (d, H, D)
        out.append((x.reshape(B * S, d) @ w.reshape(d, -1))
                   .view(B, S, *w.shape[1:]))
    q, k, v = out
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_output(p: Schema, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, D) -> (B, S, d_model) through ``wo`` (H, D, d_model)."""
    B, S, H, D = o.shape
    wo = p["wo"].to(o.dtype)
    return (o.reshape(B * S, H * D) @ wo.reshape(H * D, -1)).view(B, S, -1)


def swiglu_schema(d_model: int, d_ff: int,
                  layer_dims: Tuple[int, ...] = ()) -> Schema:
    L = layer_dims
    la = tuple("layer" for _ in L)
    return {
        "w_gate": ParamDef(L + (d_model, d_ff), la + ("embed", "mlp"), "fan_in"),
        "w_up": ParamDef(L + (d_model, d_ff), la + ("embed", "mlp"), "fan_in"),
        "w_down": ParamDef(L + (d_ff, d_model), la + ("mlp", "embed"), "fan_in"),
    }


def lora_delta(x: torch.Tensor, lora_t: Dict[str, torch.Tensor],
               scale: float) -> torch.Tensor:
    """x (..., d_in) -> (..., *out) P-LoRA delta ``scale * ((x @ a) @ b)``
    in x's dtype, the reference's order; ``a`` is (d_in, r) or (H, hd, r)
    (``wo``, whose x is the attention output flattened to H * hd), ``b``
    (r, H, hd) or (r, f)."""
    a = lora_t["a"].to(x.dtype).reshape(-1, lora_t["a"].shape[-1])
    b = lora_t["b"].to(x.dtype)
    h = x.reshape(-1, a.shape[0]) @ a
    y = (h @ b.reshape(b.shape[0], -1)).view(*x.shape[:-1], *b.shape[1:])
    return scale * y


def swiglu(p: Schema, x: torch.Tensor, lora: Optional[Dict] = None,
           lora_scale: float = 0.0) -> torch.Tensor:
    """SwiGLU FFN: the gate's SiLU in fp32, cast back, times up; with the
    ``lora`` deltas of ``w_gate``/``w_up``/``w_down`` (that of ``w_down``
    on the post-activation h), as the reference's transformer adds them.

    fp32 activations on bf16 weights with no gradient recorded and no
    LoRA delta on the MLP (the vision tower serving) take the split GEMMs
    (``kernels/split_gemm``): the weights as stored, the fp32 products on
    the tensor cores, SiLU(g) * u inside the gate/up kernel."""
    lora = lora or {}
    ws = (p["w_gate"], p["w_up"], p["w_down"])
    if not any(k in lora for k in ("w_gate", "w_up", "w_down")) and \
            split_gemm.takes(x, *ws):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        h = split_gemm.swiglu_gate_up(x2, ws[0], ws[1])
        return split_gemm.matmul(h, ws[2]).view(*x.shape[:-1], -1)
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    if "w_gate" in lora:
        g = g + lora_delta(x, lora["w_gate"], lora_scale)
    if "w_up" in lora:
        u = u + lora_delta(x, lora["w_up"], lora_scale)
    h = F.silu(g.float()).to(x.dtype) * u
    y = h @ p["w_down"].to(x.dtype)
    if "w_down" in lora:
        y = y + lora_delta(h, lora["w_down"], lora_scale)
    return y


def mlp_schema(dims: Sequence[int], name_axes: Tuple[str, str] = ("embed", "mlp"),
               bias: bool = True) -> Schema:
    """Plain feed-forward stack ``dims[0] -> dims[1] -> ... -> dims[-1]``."""
    s: Schema = {}
    for i in range(len(dims) - 1):
        s[f"w{i}"] = ParamDef((dims[i], dims[i + 1]), name_axes, "fan_in")
        if bias:
            s[f"b{i}"] = ParamDef((dims[i + 1],), (name_axes[1],), "zeros")
    return s


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: Schema, x: torch.Tensor, *, act=torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"].to(x.dtype)
        if f"b{i}" in p:
            x = x + p[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def embed_schema(vocab: int, d: int) -> ParamDef:
    return ParamDef((vocab, d), ("vocab", "embed"), "embed")


class _EmbedLookup(torch.autograd.Function):
    """``table[ids]`` whose table gradient is summed in float32 and cast to
    the table's dtype once (the reference's custom VJP of the LM lookup),
    in a fixed order: an accumulating ``index_put_`` sorts the ids (a
    stable sort on CUDA) and adds each row's terms in that order, so the
    same bits come out twice, where autograd of ``table[ids]`` would
    scatter into the bf16 table with atomics."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        d = torch.zeros(ctx.table_shape, dtype=torch.float32,
                        device=g.device)
        d.index_put_((ids.reshape(-1),), g.reshape(-1, g.shape[-1]).float(),
                     accumulate=True)
        return d.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` by id; out-of-range ids are clamped, as the
    reference's ``jnp.take(..., mode="clip")`` does. Differentiable in
    ``table`` through ``_EmbedLookup``."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, ids)
    return table[ids]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """(num_segments, ...) sums of ``data``'s rows by ``segment_ids``; a row
    whose id lies outside [0, num_segments) is dropped, as
    ``jax.ops.segment_sum`` drops it. The rows are added by an
    accumulating ``index_put_``, which sorts the ids and adds each
    segment's rows in that fixed order (no atomics on the card); its
    gradient is a gather."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + data.shape[1:])
    out = out.index_put((ids,), data, accumulate=True)
    return out[:num_segments]


# ---------------------------------------------------------------------------
# Losses / misc
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V), labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xf = x.float()
    n = torch.linalg.norm(xf, dim=-1, keepdim=True)
    return (xf / torch.clamp_min(n, eps)).to(x.dtype)
