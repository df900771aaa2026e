"""bst [arXiv:1905.06874, Alibaba Behavior Sequence Transformer]:
embed_dim=32, behaviour seq_len=20 (+ target), 1 transformer block, 8 heads,
final MLP 1024-512-256. Item vocab 4M (Taobao scale)."""
from repro_torch.configs.base import (ArchSpec, RecallConfig, RecsysConfig,
                                      recsys_shapes, register)

register(ArchSpec(
    arch_id="bst",
    family="recsys",
    model=RecsysConfig(
        kind="bst", embed_dim=32, seq_len=20, item_vocab=4_000_000,
        n_heads=8, n_blocks=1, mlp=(1024, 512, 256),
        interaction="transformer-seq"),
    shapes=recsys_shapes(),
    recall=RecallConfig(enabled=False),  # inapplicable: depth-1 encoder (DESIGN.md §5)
    source="arXiv:1905.06874",
))
