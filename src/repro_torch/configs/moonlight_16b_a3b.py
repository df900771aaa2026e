"""moonlight-16b-a3b [hf:moonshotai/Moonlight-16B-A3B, ``model_type``
deepseek_v3] at its published widths: 27 layers, d 2,048, 16 heads of
MLA (``q_lora_rank`` null, ``kv_lora_rank`` 512, qk nope 128 + rope 64,
v 128), RoPE theta 50,000 (no scaling), RMSNorm eps 1e-5; layer 0 a dense
SwiGLU 11,264 wide (``first_k_dense_replace`` 1), layers 1-26 MoE with 64
routed experts of 1,408, top-6, and 2 shared experts, DeepSeek-V3's
sigmoid router (``noaux_tc``, one group, ``norm_topk_prob``,
``routed_scaling_factor`` 2.446); vocab 163,840, untied head. A port-only
arch (``moonshot-v1-16b-a3b`` is the reference's simplified copy)."""
from repro_torch.configs.base import (ArchSpec, MLAConfig, MLALMConfig,
                                      MoEConfig, RecallConfig, RouterConfig,
                                      lm_shapes, register_port)

register_port(ArchSpec(
    arch_id="moonlight-16b-a3b",
    family="lm",
    model=MLALMConfig(
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=192,
        d_ff=11264, vocab=163840, rope_theta=5e4, norm_eps=1e-5,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared_experts=2),
        dtype="bfloat16",
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        router=RouterConfig(routed_scaling_factor=2.446,
                            norm_topk_prob=True),
        first_k_dense=1),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=4, superficial_layers=7,
                        lora_targets=("wq", "wo")),
    source="hf:moonshotai/Moonlight-16B-A3B",
))
