"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (GQA kv=4)
head_dim=128, MoE 128 experts top-8, expert d_ff=768, vocab 151936."""
from repro_torch.configs.base import (ArchSpec, LMConfig, MoEConfig,
                                      RecallConfig, lm_shapes, register)

register(ArchSpec(
    arch_id="qwen3-moe-30b-a3b",
    family="lm",
    model=LMConfig(
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=0, vocab=151936, rope_theta=1e6,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        dtype="bfloat16"),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=4, superficial_layers=7,
                        lora_targets=("wq", "wk", "wv", "wo")),
    source="hf:Qwen/Qwen3-30B-A3B",
))
