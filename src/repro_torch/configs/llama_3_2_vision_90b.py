"""llama-3.2-vision-90b — VLM backbone; cross-attn image layers; stub vision
frontend.  [hf:meta-llama/Llama-3.2-11B-Vision]

Every 5th layer gets an additional gated cross-attention block reading stub
patch embeddings (``input_specs()`` provides (batch, 1601, 8192)).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    cross_attn_period=5,
    num_image_tokens=1601,
    rope_theta=500_000.0,
    notes="Backbone only; vision tower stubbed as precomputed patch embeddings.",
)
