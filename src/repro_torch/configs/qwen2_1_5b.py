"""qwen2-1.5b [arXiv:2407.10671]: 28L d=1536 12H (GQA kv=2) head_dim=128,
d_ff=8960, vocab 151936, QKV bias, tied embeddings."""
from repro_torch.configs.base import (ArchSpec, LMConfig, RecallConfig,
                                      lm_shapes, register)

register(ArchSpec(
    arch_id="qwen2-1.5b",
    family="lm",
    model=LMConfig(
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
        d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True, dtype="bfloat16"),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=4, superficial_layers=7),
    source="arXiv:2407.10671",
))
