"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, GRU dim 108,
AUGRU interest evolution, final MLP 200-80. Item vocab 1M."""
from repro_torch.configs.base import (ArchSpec, RecallConfig, RecsysConfig,
                                      recsys_shapes, register)

register(ArchSpec(
    arch_id="dien",
    family="recsys",
    model=RecsysConfig(
        kind="dien", embed_dim=18, seq_len=100, item_vocab=1_000_000,
        gru_dim=108, mlp=(200, 80), interaction="augru"),
    shapes=recsys_shapes(),
    recall=RecallConfig(enabled=False),  # inapplicable: recurrence over time,
                                         # not depth (DESIGN.md §5)
    source="arXiv:1809.03672 [unverified per pool]",
))
