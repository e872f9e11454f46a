"""famous-bert — the paper's own evaluation topology.

FAMOUS (Table I) synthesises for a BERT variant: d_model=768, h=8, SL=64,
TS=64, 8-bit data.  This config reproduces that topology as an encoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="famous-bert",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=8,
        num_kv_heads=8,
        d_ff=3072,
        vocab_size=30522,
        causal=False,
        rope=False,
        norm="layernorm",
        act="gelu",
        source="FAMOUS paper Table I (BERT variant [6])",
    )
)
