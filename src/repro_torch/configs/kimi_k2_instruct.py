"""kimi-k2-instruct — Kimi-K2-Instruct as released: DeepSeek-V3's block.

[hf:moonshotai/Kimi-K2-Instruct config.json]
61L d_model=7168, layer 0 dense (SwiGLU d_ff 18432), layers 1-60 MoE:
384 routed experts of width 2048, top-8 by sigmoid score plus a
correction bias, weights normalised and scaled by 2.827, every token
routed, one shared expert of width 2048.  Latent attention (MLA), 64
heads: q through a rank-1536 bottleneck, K/V from one 512-value latent
row and a 64-dim rotary key shared by the heads; heads of 128 + 64 for
the scores and 128 for the values; YaRN rope (theta 50000, factor 32 over
4096 positions, beta_fast 1, beta_slow 1).  Vocabulary 163840, untied
head.  A configuration of the port only (``base.PORT_ONLY``): the JAX
package has no such block.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="kimi-k2-instruct",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=64,
        head_dim=192,
        d_ff=2048,
        vocab_size=163840,
        rope_theta=50000.0,
        num_experts=384,
        experts_per_token=8,
        scoring_func="sigmoid",
        routed_scaling_factor=2.827,
        shared_experts=1,
        first_dense_layers=1,
        dense_d_ff=18432,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        yarn_factor=32.0,
        yarn_original_max=4096,
        yarn_beta_fast=1.0,
        yarn_beta_slow=1.0,
        yarn_mscale=1.0,
        yarn_mscale_all_dim=1.0,
        source="hf:moonshotai/Kimi-K2-Instruct",
    )
)
