"""command-r-plus-104b — large dense GQA decoder, no biases.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        tie_embeddings=True,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
)
