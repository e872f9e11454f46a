"""hubert-xlarge — encoder-only audio transformer (wav2vec2 architecture).

[arXiv:2106.07447; unverified]
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (codebook targets).

Encoder-only: bidirectional attention, no decode step (decode shapes are
skipped, see DESIGN.md §6).  The CNN waveform frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        rope=False,
        norm="layernorm",
        act="gelu",
        frontend="audio",
        source="arXiv:2106.07447; unverified",
    )
)
