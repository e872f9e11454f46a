"""deepseek-7b — llama-architecture dense decoder (MHA: kv == heads).

[arXiv:2401.02954; hf]  30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=102400,
        source="arXiv:2401.02954; hf",
    )
)
