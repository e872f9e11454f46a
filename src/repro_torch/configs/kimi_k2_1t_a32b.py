"""kimi-k2-1t-a32b — the JAX package's GQA placeholder for Kimi-K2, not
the published model: 384 experts, top-8.

[arXiv:2501.kimi2; unverified]
61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8,
softmax GShard routing with capacity; no latent attention, no shared
expert, no dense first layer.  It stays the twin of the JAX registry's
entry; the released model is ``kimi-k2-instruct``.
``d_ff`` is the per-expert hidden width (fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=163840,
        num_experts=384,
        experts_per_token=8,
        source="arXiv:2501.kimi2; unverified",
    )
)
