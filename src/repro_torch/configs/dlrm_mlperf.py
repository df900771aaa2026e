"""dlrm-mlperf [arXiv:1906.00091, MLPerf v0.7 Criteo-1TB config]:
13 dense + 26 sparse features, embed_dim=128, bot 13-512-256-128,
top 1024-1024-512-256-1, dot interaction. Table vocab sizes are the
published Criteo Terabyte cardinalities (~188M rows, ~96GB fp32 — row-
sharded over the (data, model) mesh axes)."""
from repro_torch.configs.base import (ArchSpec, RecallConfig, RecsysConfig,
                                      recsys_shapes, register)

CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)

register(ArchSpec(
    arch_id="dlrm-mlperf",
    family="recsys",
    model=RecsysConfig(
        kind="dlrm", embed_dim=128, table_vocabs=CRITEO_1TB_VOCABS,
        n_dense=13, bot_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1), interaction="dot"),
    shapes=recsys_shapes(),
    recall=RecallConfig(enabled=False),  # inapplicable: no layered encoder (DESIGN.md §5)
    source="arXiv:1906.00091",
))
