"""recall-imagebind — the paper's own architecture: ImageBind-style MEM
(vision ViT-H 32L/1280, text 24L/1024, audio 12L/768, IMU 6L/512 towers ->
shared 1024-d space). Modality frontends are stubs (precomputed patch/frame
features); the vision tower matches the paper's 32-layer module whose
average zero-shot exit is 21.4 layers (§3.1)."""
from repro_torch.configs.base import (ArchSpec, MEMConfig, RecallConfig,
                                      ShapeConfig, TowerConfig, register)

register(ArchSpec(
    arch_id="recall-imagebind",
    family="mem",
    model=MEMConfig(
        towers=(
            TowerConfig("vision", n_layers=32, d_model=1280, n_heads=16,
                        d_ff=5120, n_tokens=256, d_input=1024),
            TowerConfig("text", n_layers=24, d_model=1024, n_heads=16,
                        d_ff=4096, n_tokens=77, d_input=0, vocab=49408),
            TowerConfig("audio", n_layers=12, d_model=768, n_heads=12,
                        d_ff=3072, n_tokens=228, d_input=128),
            TowerConfig("imu", n_layers=6, d_model=512, n_heads=8,
                        d_ff=2048, n_tokens=391, d_input=48),
        ),
        embed_dim=1024, dtype="bfloat16"),
    shapes=(
        ShapeConfig("embed_stream", "serve", global_batch=1024),   # embedding runtime
        ShapeConfig("heal_step", "train", global_batch=256),       # P-LoRA healing
        ShapeConfig("query_batch", "retrieval", global_batch=64,
                    n_candidates=1_000_000),                        # query runtime
    ),
    recall=RecallConfig(exit_interval=4, superficial_layers=7),
    source="paper (ImageBind backbone, arXiv:2305.05665)",
))
