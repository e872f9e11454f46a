"""qwen3-32b — dense GQA decoder with per-head qk RMSNorm.

[hf:Qwen/Qwen3-8B; hf]  64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B; hf",
    )
)
