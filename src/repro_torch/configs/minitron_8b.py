"""minitron-8b [arXiv:2407.14679]: pruned Nemotron, 32L d=4096 32H (GQA kv=8)
head_dim=128, d_ff=16384, vocab 256000."""
from repro_torch.configs.base import (ArchSpec, LMConfig, RecallConfig,
                                      lm_shapes, register)

register(ArchSpec(
    arch_id="minitron-8b",
    family="lm",
    model=LMConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab=256000, rope_theta=5e5, dtype="bfloat16"),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=4, superficial_layers=7),
    source="arXiv:2407.14679",
))
