"""phi3-medium-14b — dense, RoPE SwiGLU GQA kv=10.  [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100_352,
    rope_theta=10_000.0,
    notes=(
        "n_kv_heads=10 does not divide the 16-way model axis; KV projections "
        "and cache are replicated across `model` (counted in roofline)."
    ),
)
