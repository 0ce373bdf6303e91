"""granite-3-2b — dense GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    notes="vocab 49155 padded to the next multiple of 256 for model-axis sharding.",
)
