"""whisper-base — audio encoder-decoder backbone; conv frontend stubbed.
[arXiv:2212.04356]

``input_specs()`` provides precomputed (batch, 1500, 512) frame embeddings
for the encoder; the 2x conv1d stem is a stub per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    n_audio_ctx=1500,
    mlp_type="gelu",
    rope_theta=10_000.0,  # adaptation: RoPE in place of Whisper's learned PE
    notes=(
        "Tiny model: attention weights replicated across the model axis "
        "(8 heads < 16-way TP); only MLPs are tensor-parallel.  Decode "
        "shapes run (enc-dec, not encoder-only); long_500k skipped "
        "(full attention)."
    ),
)
