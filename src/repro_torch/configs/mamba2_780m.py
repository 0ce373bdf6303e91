"""mamba2-780m — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4),
    tie_embeddings=True,
    notes=(
        "Attention-free: flash-attention kernel unused; the SSD chunked-scan "
        "kernel is the hot spot.  Constant-size recurrent state -> long_500k "
        "runnable.  d_ff=0: no separate MLP (Mamba block is the whole layer)."
    ),
)
