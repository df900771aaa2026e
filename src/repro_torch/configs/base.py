"""Config dataclasses and registry for the port (every family of the
reference: ``mem``, ``lm``, ``gnn`` and ``recsys``).

A copy of ``repro.configs.base``, so the port imports nothing of the JAX
package. Field names and defaults are the reference's;
``tests/test_torch_imports.py`` keeps the port free of ``repro`` imports and
the parity tests keep the values equal.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3, ``q_lora_rank`` null):
    q = x W_q, (H, nope + rope) a token; [c_kv | k_pe] = x W_kv_a, c_kv
    RMS-normed (``latent_norm_eps``: the modeling file's default, not the
    config's ``rms_norm_eps``); [k_nope | v] = c_kv W_kv_b, (H, nope + v)
    a token; RoPE on q's rope part and on the one k_pe head all heads
    share. The cache holds a token's normed c_kv and roped k_pe. With
    ``nope`` (Kimi Linear's ``mla_use_nope``) no RoPE is applied: q's and
    k_pe's rope-wide parts enter the scores as they are, and the cache
    holds k_pe unrotated."""

    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    latent_norm_eps: float = 1e-6
    nope: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a token's row in the latent cache."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention (Kimi Linear's ``linear_attn_config``):
    ``n_heads`` heads of ``head_dim`` (dk = dv); q, k and v each a
    projection, a causal depthwise convolution ``conv_size`` wide and a
    SiLU; q and k L2-normed per head; beta = sigmoid(x W_b); the log-decay
    g = -exp(A_log) softplus(x W_fa W_fb + dt_bias), per channel; the
    gated delta rule's state (dk, dv) a head; o RMS-normed per head
    (``norm_eps``) and gated by sigmoid(x W_ga W_gb + b_g), then W_o.
    ``gate_rank`` is the low-rank width of W_f and W_g (the modeling
    file's head_dim; the config does not give it)."""

    n_heads: int
    head_dim: int
    conv_size: int = 4
    gate_rank: int = 128
    norm_eps: float = 1e-5

    @property
    def width(self) -> int:
        return self.n_heads * self.head_dim

    def n_params(self, d: int) -> int:
        """One KDA layer's attention parameters at model width ``d``: W_q,
        W_k, W_v, W_o, the three convolutions, W_fa, W_fb, dt_bias, A_log,
        W_b, W_ga, W_gb, b_g and the norm's scale."""
        w, r, H = self.width, self.gate_rank, self.n_heads
        return (4 * d * w + 3 * self.conv_size * w + 2 * (d * r + r * w)
                + 2 * w + H + d * H + self.head_dim)


@dataclass(frozen=True)
class RouterConfig:
    """DeepSeek-V3's router (``topk_method`` noaux_tc): sigmoid scores in
    fp32, the top-k chosen on scores + ``e_score_correction_bias``, the
    weights the unbiased scores, renormalised (``norm_topk_prob``) and
    times ``routed_scaling_factor``; no token is dropped. Only one expert
    group (``n_group`` = ``topk_group`` = 1) is implemented."""

    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1


@dataclass(frozen=True)
class LMConfig:
    """Decoder-style transformer (also used bidirectionally for encoders)."""

    # DeepSeek-V3-style blocks (``MLALMConfig``'s fields; class attributes
    # here, so that this dataclass's fields stay the reference's)
    mla = None
    router = None
    first_k_dense = 0
    kda = None          # and ``HybridLMConfig``'s
    kda_layers = ()

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    causal: bool = True
    window: int = 0  # 0 = full attention; >0 = sliding window
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, \
            self.head_dim
        return d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d

    def _embed_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Analytic parameter count (the reference's, for 6ND roofline
        terms)."""
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            ff_exp = 3 * d * m.d_ff_expert  # gate+up+down (SwiGLU)
            ff = (m.n_experts * ff_exp + m.n_shared_experts * ff_exp
                  + d * m.n_experts)
        else:
            ff = 3 * d * self.d_ff
        per_layer = self._attn_params() + ff + 2 * d  # two norms
        return self.n_layers * per_layer + self._embed_params() + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE counts only routed top-k experts)."""
        if self.moe is None:
            return self.n_params
        d, m = self.d_model, self.moe
        ff_exp = 3 * d * m.d_ff_expert
        per_layer = (self._attn_params() + (m.top_k + m.n_shared_experts)
                     * ff_exp + d * m.n_experts + 2 * d)
        return self.n_layers * per_layer + self._embed_params() + d


@dataclass(frozen=True)
class MLALMConfig(LMConfig):
    """A DeepSeek-V3-style decoder: MLA attention (``mla``; ``n_heads`` =
    ``n_kv_heads``, ``d_head`` the q/k head dim), the first
    ``first_k_dense`` layers a dense SwiGLU ``d_ff`` wide, the rest MoE
    layers routed by ``router`` (dropless), ``moe.n_shared_experts``
    experts always on as one SwiGLU ``n_shared * d_ff_expert`` wide. No
    such config exists in the reference."""

    mla: Optional[MLAConfig] = None
    router: Optional[RouterConfig] = None
    first_k_dense: int = 0

    def _attn_params(self) -> int:
        m, d, h = self.mla, self.d_model, self.n_heads
        return (d * h * m.qk_head_dim + d * m.latent_dim + m.kv_lora_rank
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                + h * m.v_head_dim * d)

    def _ffn_params(self, active: bool) -> int:
        d, m = self.d_model, self.moe
        routed = m.top_k if active else m.n_experts
        moe = ((routed + m.n_shared_experts) * 3 * d * m.d_ff_expert
               + d * m.n_experts + m.n_experts)
        return (self.first_k_dense * 3 * d * self.d_ff
                + (self.n_layers - self.first_k_dense) * moe)

    @property
    def n_params(self) -> int:
        per_layer = self._attn_params() + 2 * self.d_model
        return (self.n_layers * per_layer + self._ffn_params(False)
                + self._embed_params() + self.d_model)

    @property
    def n_active_params(self) -> int:
        per_layer = self._attn_params() + 2 * self.d_model
        return (self.n_layers * per_layer + self._ffn_params(True)
                + self._embed_params() + self.d_model)


@dataclass(frozen=True)
class HybridLMConfig(MLALMConfig):
    """An MLALMConfig whose layers ``kda_layers`` (0-indexed) are KDA
    layers (``kda``) and the rest MLA layers (Kimi Linear's hybrid, its
    ``linear_attn_config`` lists 1-indexed). No such config exists in the
    reference."""

    kda: Optional[KDAConfig] = None
    kda_layers: Tuple[int, ...] = ()

    def _attn_total(self) -> int:
        n_kda = len(self.kda_layers)
        return ((self.n_layers - n_kda) * self._attn_params()
                + n_kda * self.kda.n_params(self.d_model)
                + self.n_layers * 2 * self.d_model)

    @property
    def n_params(self) -> int:
        return (self._attn_total() + self._ffn_params(False)
                + self._embed_params() + self.d_model)

    @property
    def n_active_params(self) -> int:
        return (self._attn_total() + self._ffn_params(True)
                + self._embed_params() + self.d_model)


@dataclass(frozen=True)
class GNNConfig:
    n_layers: int
    d_hidden: int
    aggregator: str = "gated"  # gatedgcn
    d_feat: int = 128
    d_edge_feat: int = 0
    n_classes: int = 40
    norm_eps: float = 1e-5
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    kind: str  # "bst" | "dlrm" | "sasrec" | "dien"
    embed_dim: int
    # Sparse feature tables: list of vocab sizes (one per field).
    table_vocabs: Tuple[int, ...] = ()
    n_dense: int = 0
    seq_len: int = 0
    item_vocab: int = 0
    n_heads: int = 1
    n_blocks: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    gru_dim: int = 0
    interaction: str = "dot"
    dtype: str = "float32"


@dataclass(frozen=True)
class TowerConfig:
    """One MEM modality tower (transformer encoder on stub frontend tokens)."""

    modality: str  # "vision" | "text" | "audio" | "imu"
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_tokens: int  # sequence length after the (stub) frontend
    d_input: int  # frontend feature dim (patch/frame/token-embedding dim)
    vocab: int = 0  # text only


@dataclass(frozen=True)
class MEMConfig:
    """ImageBind-style multimodal embedding model."""

    towers: Tuple[TowerConfig, ...]
    embed_dim: int = 1024
    logit_scale_init: float = 14.285  # 1/0.07, CLIP default
    norm_eps: float = 1e-6
    dtype: str = "float32"

    def tower(self, modality: str) -> TowerConfig:
        for t in self.towers:
            if t.modality == modality:
                return t
        raise KeyError(modality)


@dataclass(frozen=True)
class RecallConfig:
    """Knobs for the paper's technique."""

    enabled: bool = True
    exit_interval: int = 4           # exit tap every k layers
    superficial_layers: int = 7      # N in the paper (pre-exit reads layer-N state)
    predictor_hidden: int = 256      # pre-exit MLP hidden width
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    plora_min_step: int = 1
    plora_max_step: int = 4
    filter_top_k: int = 10           # speculative filter width per granularity
    query_granularities: int = 3     # how many exit depths to embed the query at
    cache_bits: int = 4              # activation cache quantization
    pool: str = "mean"               # how hidden states are pooled into embeddings

    def exit_layers(self, n_layers: int) -> Tuple[int, ...]:
        """1-indexed exit depths (always includes the final layer)."""
        if not self.enabled:
            return (n_layers,)
        exits = list(range(self.exit_interval, n_layers, self.exit_interval))
        if not exits or exits[-1] != n_layers:
            exits.append(n_layers)
        return tuple(exits)


@dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: names the step and its global dims."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval | graph_full |
    #            graph_mini | graph_batched
    global_batch: int = 0
    seq_len: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    # recsys
    n_candidates: int = 0
    skip_reason: str = ""


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys" | "mem"
    model: Any  # LMConfig | GNNConfig | RecsysConfig | MEMConfig
    shapes: Tuple[ShapeConfig, ...]
    recall: RecallConfig = RecallConfig()
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeConfig:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: no shape {name!r}")


_REGISTRY: Dict[str, ArchSpec] = {}

_ARCH_MODULES = ["qwen3_moe_30b_a3b", "moonshot_v1_16b_a3b", "minitron_8b",
                 "deepseek_67b", "qwen2_1_5b", "gatedgcn", "bst",
                 "dlrm_mlperf", "sasrec", "dien", "recall_imagebind"]
# archs of the port alone (no JAX twin): ``get_arch`` finds them,
# ``list_archs`` and ``all_cells`` (the reference's registry) do not
_PORT_MODULES = ["moonlight_16b_a3b", "kimi_linear_48b_a3b"]
_PORT_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def register_port(spec: ArchSpec) -> ArchSpec:
    """Register an arch of the port alone (no JAX twin)."""
    _PORT_REGISTRY[spec.arch_id] = spec
    return spec


def _ensure_loaded() -> None:
    for mod in _ARCH_MODULES + _PORT_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    for reg in (_REGISTRY, _PORT_REGISTRY):
        for key in (arch_id.replace("_", "-"), arch_id):
            if key in reg:
                return reg[key]
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{sorted(_REGISTRY) + port_archs()}")


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def port_archs() -> List[str]:
    """The archs of the port alone (not in ``list_archs``)."""
    _ensure_loaded()
    return sorted(_PORT_REGISTRY)


def all_cells() -> List[Tuple[str, str]]:
    """All (arch_id, shape_name) cells, including documented skips."""
    _ensure_loaded()
    return [(a, s.name) for a in list_archs() for s in _REGISTRY[a].shapes]


def smoke_variant(spec: ArchSpec) -> ArchSpec:
    """Shrink a full config to a CPU-runnable one of the same family (the
    reference's branches, value for value)."""
    m = spec.model
    rc = replace(spec.recall, exit_interval=1, superficial_layers=1)
    if spec.family == "lm":
        moe = None
        if m.moe is not None:
            moe = replace(m.moe, n_experts=4, top_k=2, d_ff_expert=64,
                          n_shared_experts=min(m.moe.n_shared_experts, 1))
        sm = replace(m, n_layers=4, d_model=64, n_heads=4,
                     n_kv_heads=min(m.n_kv_heads, 2), d_head=16, d_ff=128,
                     vocab=512, moe=moe, dtype="float32")
        if m.mla is not None:   # no reference branch: the port's own
            sm = replace(sm, n_layers=3, n_kv_heads=4, d_head=24,
                         mla=replace(m.mla, kv_lora_rank=32,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16))
        if m.kda is not None:   # a hybrid: 3 KDA layers, then an MLA one
            sm = replace(sm, n_layers=4,
                         kda=replace(m.kda, n_heads=4, head_dim=16,
                                     gate_rank=8),
                         kda_layers=tuple(i for i in m.kda_layers if i < 4))
        shapes = (ShapeConfig("smoke_train", "train", global_batch=4,
                              seq_len=32),
                  ShapeConfig("smoke_decode", "decode", global_batch=4,
                              seq_len=64))
    elif spec.family == "gnn":
        sm = replace(m, n_layers=3, d_hidden=16, d_feat=8, n_classes=5)
        shapes = (ShapeConfig("smoke_graph", "graph_full", n_nodes=64,
                              n_edges=256, d_feat=8),)
    elif spec.family == "recsys":
        embed_dim = min(m.embed_dim, 16)
        bot = tuple(min(x, 32) for x in m.bot_mlp)
        if m.kind == "dlrm" and bot:
            bot = bot[:-1] + (embed_dim,)  # DLRM invariant: bot out == embed
        sm = replace(
            m, embed_dim=embed_dim,
            table_vocabs=tuple(min(v, 128) for v in m.table_vocabs),
            seq_len=min(m.seq_len, 8) if m.seq_len else 0,
            item_vocab=min(m.item_vocab, 128) if m.item_vocab else 0,
            bot_mlp=bot, top_mlp=tuple(min(x, 32) for x in m.top_mlp),
            mlp=tuple(min(x, 32) for x in m.mlp),
            gru_dim=min(m.gru_dim, 16) if m.gru_dim else 0)
        shapes = (ShapeConfig("smoke_train", "train", global_batch=16),
                  ShapeConfig("smoke_serve", "serve", global_batch=8))
        rc = spec.recall
    elif spec.family == "mem":
        towers = tuple(
            replace(t, n_layers=3, d_model=32, n_heads=2, d_ff=64,
                    n_tokens=min(t.n_tokens, 16), d_input=min(t.d_input, 24),
                    vocab=min(t.vocab, 256) if t.vocab else 0)
            for t in m.towers
        )
        sm = replace(m, towers=towers, embed_dim=32)
        shapes = (ShapeConfig("smoke_embed", "serve", global_batch=8),)
    else:
        raise ValueError(spec.family)
    return replace(spec, arch_id=spec.arch_id + "-smoke", model=sm,
                   shapes=shapes, recall=rc)


def lm_shapes(full_attention: bool) -> Tuple[ShapeConfig, ...]:
    """The standard LM shape set of every LM arch (the reference's)."""
    skip = ("pure full-attention arch: 524k-token context needs "
            "sub-quadratic attention (see DESIGN.md §5); runnable via "
            "--window sliding-window extension") if full_attention else ""
    return (
        ShapeConfig("train_4k", "train", global_batch=256, seq_len=4096),
        ShapeConfig("prefill_32k", "prefill", global_batch=32, seq_len=32768),
        ShapeConfig("decode_32k", "decode", global_batch=128, seq_len=32768),
        ShapeConfig("long_500k", "decode", global_batch=1, seq_len=524288,
                    skip_reason=skip),
    )


def recsys_shapes() -> Tuple[ShapeConfig, ...]:
    """The standard recsys shape set of every recsys arch (the
    reference's)."""
    return (
        ShapeConfig("train_batch", "train", global_batch=65536),
        ShapeConfig("serve_p99", "serve", global_batch=512),
        ShapeConfig("serve_bulk", "serve", global_batch=262144),
        ShapeConfig("retrieval_cand", "retrieval", global_batch=1,
                    n_candidates=1_000_000),
    )
