"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Pattern: (rglru, rglru, local_attn) repeated; 26 % 3 = 2 trailing rglru layers.
Local attention window 2048 (Griffin), GeLU MLP, RMSNorm.
"""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        pattern_unit=(RGLRU, RGLRU, LOCAL_ATTN),
        window=2048,
        lru_width=2560,
        conv_width=4,
        act="gelu",
        rope=True,
        tie_embeddings=True,
        source="arXiv:2402.19427; hf",
    )
)
