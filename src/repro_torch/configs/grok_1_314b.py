"""grok-1-314b — MoE decoder: 8 experts, top-2 routing.

[hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        logit_softcap=30.0,
        act="gelu",
        source="hf:xai-org/grok-1; unverified",
    )
)
