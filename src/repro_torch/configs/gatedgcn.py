"""gatedgcn [arXiv:2003.00982 benchmarking-gnns]: 16 rounds, d_hidden=70,
gated aggregation. Per-shape input dims follow the public datasets the cells
reference: full_graph_sm=Cora (d=1433, 7 cls), minibatch_lg=Reddit (d=602,
41 cls), ogb_products (d=100, 47 cls), molecule=ZINC-like batched small
graphs (d=16)."""
from repro_torch.configs.base import (ArchSpec, GNNConfig, RecallConfig,
                                      ShapeConfig, register)

register(ArchSpec(
    arch_id="gatedgcn",
    family="gnn",
    model=GNNConfig(n_layers=16, d_hidden=70, aggregator="gated",
                    d_feat=100, n_classes=47),
    shapes=(
        ShapeConfig("full_graph_sm", "graph_full", n_nodes=2708, n_edges=10556,
                    d_feat=1433),
        ShapeConfig("minibatch_lg", "graph_mini", n_nodes=232965,
                    n_edges=114615892, batch_nodes=1024, fanout=(15, 10),
                    d_feat=602),
        ShapeConfig("ogb_products", "graph_full", n_nodes=2449029,
                    n_edges=61859140, d_feat=100),
        ShapeConfig("molecule", "graph_batched", n_nodes=30, n_edges=64,
                    global_batch=128, d_feat=16),
    ),
    recall=RecallConfig(exit_interval=2, superficial_layers=3,
                        lora_targets=()),  # healing tunes full rounds (tiny model)
    source="arXiv:2003.00982",
))
