"""rwkv6-1.6b "Finch" — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; unverified]
24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.

FAMOUS's attention tiling is inapplicable (no softmax attention); the block is
the wkv6 linear recurrence (chunked kernel, see kernels/scan).  Noted in
DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import RWKV6, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,           # wkv heads = d_model / rwkv_head_dim
        num_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        pattern_unit=(RWKV6,),
        rwkv_head_dim=64,
        rope=False,
        norm="layernorm",
        act="relu_sq",
        source="arXiv:2404.05892; unverified",
    )
)
