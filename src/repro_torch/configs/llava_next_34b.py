"""llava-next-34b — VLM: decoder LM backbone + anyres patch-embedding stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Per the assignment, the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (the anyres tiler output) alongside text tokens;
the backbone consumes the concatenated embedding sequence.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        frontend="vlm",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    )
)
