"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Period of 8 layers with attention at offset 4 (1 attn : 7 mamba); MoE on
every other layer (moe_period=2).  The original Jamba uses Mamba-1 with
d_state=16; the reference uses the SSD (Mamba-2) formulation with the
same small state, and so does the port.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65_536,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14336),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_kernel=4),
    attn_period=8,
    attn_offset=4,
    moe_period=2,
    moe_offset=1,
    rope_theta=0.0,  # Jamba uses no explicit positional embedding (Mamba carries position)
    notes="Hybrid 1:7 attn:mamba; only 4/32 layers hold KV cache -> 500k context runnable.",
)
