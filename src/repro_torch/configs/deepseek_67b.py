"""deepseek-67b [arXiv:2401.02954]: llama-arch, 95L d=8192 64H (GQA kv=8)
head_dim=128, d_ff=22016, vocab 102400."""
from repro_torch.configs.base import (ArchSpec, LMConfig, RecallConfig,
                                      lm_shapes, register)

register(ArchSpec(
    arch_id="deepseek-67b",
    family="lm",
    model=LMConfig(
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22016, vocab=102400, rope_theta=1e4, dtype="bfloat16"),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=8, superficial_layers=7),  # 12 exits
    source="arXiv:2401.02954",
))
