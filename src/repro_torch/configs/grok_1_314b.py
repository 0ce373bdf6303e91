"""grok-1-314b — MoE 8e top-2 with attention logit soft-capping.
[hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32768),
    moe_period=1,
    moe_offset=0,
    attn_logit_softcap=30.0,
    rope_theta=10_000.0,
    notes=(
        "8 experts do not divide the 16-way model axis: expert weights use "
        "TP-within-expert (d_ff sharded 16-way, experts replicated) as the "
        "baseline; EPxTP hybrid is a hillclimb lever."
    ),
)
