"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d=2048
16H (kv=16, i.e. MHA) head_dim=128, MoE 64 experts top-6, expert d_ff=1408,
vocab 163840. The JAX reference's copy, kept value for value for the parity
tests: it is NOT Moonlight's published architecture (27 layers, MLA, a
dense first layer, shared experts, sigmoid routing without drops), which
the port runs as ``moonlight-16b-a3b``. The HF model's dense first layer
and shared experts are simplified to a homogeneous all-MoE stack, as in
the reference."""
from repro_torch.configs.base import (ArchSpec, LMConfig, MoEConfig,
                                      RecallConfig, lm_shapes, register)

register(ArchSpec(
    arch_id="moonshot-v1-16b-a3b",
    family="lm",
    model=LMConfig(
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=0, vocab=163840, rope_theta=5e4,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
        dtype="bfloat16"),
    shapes=lm_shapes(full_attention=True),
    recall=RecallConfig(exit_interval=4, superficial_layers=7,
                        lora_targets=("wq", "wk", "wv", "wo")),
    source="hf:moonshotai/Moonlight-16B-A3B",
))
