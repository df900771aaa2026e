"""sasrec [arXiv:1808.09781]: embed_dim=50, 2 blocks, 1 head, seq_len=50,
self-attentive sequential recommendation. Item vocab 1M (sized for the
retrieval_cand cell)."""
from repro_torch.configs.base import (ArchSpec, RecallConfig, RecsysConfig,
                                      recsys_shapes, register)

register(ArchSpec(
    arch_id="sasrec",
    family="recsys",
    model=RecsysConfig(
        kind="sasrec", embed_dim=50, seq_len=50, item_vocab=1_000_000,
        n_heads=1, n_blocks=2, interaction="self-attn-seq"),
    shapes=recsys_shapes(),
    # marginal applicability: 2 blocks -> exit after block 1 is supported but
    # the pre-exit predictor is disabled by default (DESIGN.md §5).
    recall=RecallConfig(enabled=True, exit_interval=1, superficial_layers=1),
    source="arXiv:1808.09781",
))
