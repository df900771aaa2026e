"""kimi-linear-48b-a3b [hf:moonshotai/Kimi-Linear-48B-A3B-Instruct,
``model_type`` kimi_linear] at its published widths: 27 layers, d 2,304;
20 KDA layers (Kimi Delta Attention: 32 heads of 128, short convolutions
4 wide) and 7 MLA layers without RoPE (``mla_use_nope``: 32 heads,
``q_lora_rank`` null, ``kv_lora_rank`` 512, qk nope 128 + 64, v 128) at
the 1-indexed layers 4, 8, ..., 24 and 27 of ``linear_attn_config``;
RMSNorm eps 1e-5; layer 1 a dense SwiGLU 9,216 wide
(``first_k_dense_replace`` 1), layers 2-27 MoE with 256 routed experts of
1,024, top-8, and 1 shared expert, the sigmoid router (one group,
renormalised, ``routed_scaling_factor`` 2.446); vocab 163,840, untied
head. The low-rank width of the KDA gates (128, the head dim) and the
norms' eps are the family's convention, not the config's. A port-only
arch."""
from repro_torch.configs.base import (ArchSpec, HybridLMConfig, KDAConfig,
                                      MLAConfig, MoEConfig, RecallConfig,
                                      RouterConfig, lm_shapes, register_port)

# linear_attn_config's kda_layers, 1-indexed as published
KDA_LAYERS_1 = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
                23, 25, 26)

register_port(ArchSpec(
    arch_id="kimi-linear-48b-a3b",
    family="lm",
    model=HybridLMConfig(
        n_layers=27, d_model=2304, n_heads=32, n_kv_heads=32, d_head=192,
        d_ff=9216, vocab=163840, rope_theta=1e4, norm_eps=1e-5,
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=1024,
                      n_shared_experts=1),
        dtype="bfloat16",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128, nope=True),
        router=RouterConfig(routed_scaling_factor=2.446,
                            norm_topk_prob=True),
        first_k_dense=1,
        kda=KDAConfig(n_heads=32, head_dim=128, conv_size=4, gate_rank=128,
                      norm_eps=1e-5),
        kda_layers=tuple(i - 1 for i in KDA_LAYERS_1)),
    shapes=lm_shapes(full_attention=False),
    recall=RecallConfig(exit_interval=4, superficial_layers=7,
                        lora_targets=("wq", "wo")),
    source="hf:moonshotai/Kimi-Linear-48B-A3B-Instruct",
))
