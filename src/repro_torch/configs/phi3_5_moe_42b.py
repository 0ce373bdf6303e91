"""phi3.5-moe-42b-a6.6b — MoE 16e top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,  # = expert d_ff; all FFN layers are MoE
    vocab_size=32_064,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=6400),
    moe_period=1,
    moe_offset=0,
    rope_theta=10_000.0,
    notes="16 experts shard exactly over the 16-way model axis (pure EP).",
)
