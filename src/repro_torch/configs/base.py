"""Model configuration system (a copy of ``repro.configs.base``).

Every architecture is a :class:`ModelConfig` registered under its id
(``--arch <id>``); a :class:`ShapeConfig` names a sequence length and
global batch (``--shape <name>``); a :class:`RunConfig` bundles (arch,
shape, tensor and data parallelism).  The registry holds the same configs
as the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Layer kinds used by the generic block stack.
ATTN = "attn"            # global dense softmax attention (FAMOUS applies)
LOCAL_ATTN = "local_attn"  # sliding-window attention (FAMOUS + window mask)
RGLRU = "rglru"          # Griffin/RecurrentGemma recurrent block
RWKV6 = "rwkv6"          # RWKV-6 "Finch" time-mix block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // num_heads
    # Block stack: ``pattern_unit`` repeated ``num_layers // len(unit)`` times,
    # plus an explicit tail of ``num_layers % len(unit)`` layers.
    pattern_unit: tuple[str, ...] = (ATTN,)
    # Attention details ------------------------------------------------------
    causal: bool = True             # False for encoder-only (hubert)
    attention_bias: bool = False    # qwen2-style QKV bias (paper: B_q/B_k/B_v)
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q,k
    window: int = 0                 # local-attention window (0 = global)
    rope: bool = True
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0
    # MoE ---------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # DeepSeek-V3's routing (kimi-k2-instruct), all off by default:
    # ``scoring_func`` "sigmoid" scores ``sigmoid(x R)`` in f32, picks the
    # top-k by score plus a correction bias (its "noaux_tc"), weights the
    # chosen scores normalised to sum 1 times ``routed_scaling_factor``,
    # and routes every token (no capacity, no drop); ``shared_experts``
    # SwiGLU experts of width ``shared_experts * d_ff`` see every token.  The chip holds the routed experts
    # [expert_lo, expert_lo + experts_held) (0: all of them): the router
    # keeps its ``num_experts`` outputs and the layer computes its own
    # experts' part of the result.
    scoring_func: str = "softmax"   # softmax | sigmoid
    routed_scaling_factor: float = 1.0
    shared_experts: int = 0
    expert_lo: int = 0
    experts_held: int = 0
    # Depth: ``first_dense_layers`` leading layers with a dense FFN of
    # width ``dense_d_ff`` before the block stack (DeepSeek-V3's
    # ``first_k_dense_replace``)
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # Latent attention (MLA, DeepSeek-V3), on where ``kv_lora_rank`` > 0:
    # q through a rank ``q_lora_rank`` bottleneck, K/V from one latent row
    # of ``kv_lora_rank`` values and a shared rotary key of
    # ``qk_rope_head_dim``; heads of ``qk_nope_head_dim`` + rope dims for
    # the scores and ``v_head_dim`` for the values
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN on the rotary dims (``yarn_factor`` 0: plain rope)
    yarn_factor: float = 0.0
    yarn_original_max: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # SSM / recurrence --------------------------------------------------------
    lru_width: int = 0              # RG-LRU state width (0 -> d_model)
    conv_width: int = 4             # temporal conv in the recurrent block
    rwkv_head_dim: int = 64
    # Misc --------------------------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu | relu_sq
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # None | "audio" | "vlm" (stub embeddings)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        assert self.num_layers % len(self.pattern_unit) in range(len(self.pattern_unit))

    # ---- derived ----------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_attention_free(self) -> bool:
        return all(k in (RGLRU, RWKV6) for k in self.pattern_unit)

    @property
    def is_subquadratic(self) -> bool:
        """True if no *global* dense attention layer exists (long_500k ok)."""
        return all(k != ATTN for k in self.pattern_unit)

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def experts_here(self) -> tuple[int, int]:
        """The routed experts [lo, hi) whose weights this chip holds."""
        n = self.experts_held or self.num_experts
        return self.expert_lo, self.expert_lo + n

    @property
    def num_units(self) -> int:
        return (self.num_layers - self.first_dense_layers) \
            // len(self.pattern_unit)

    @property
    def tail_layers(self) -> tuple[str, ...]:
        n_tail = (self.num_layers - self.first_dense_layers) \
            % len(self.pattern_unit)
        return self.pattern_unit[:n_tail]

    def param_count(self) -> int:
        """Total parameters (analytic, matches init)."""
        from repro_torch.models.module import count_params
        from repro_torch.models.transformer import model_spec

        return count_params(model_spec(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        total = self.param_count()
        if self.num_experts == 0:
            return total
        lo, hi = self.experts_here
        d_ff, k = self.d_ff, self.experts_per_token
        per_expert = 3 * self.d_model * d_ff
        # every block after the leading dense ones is MoE; a token
        # multiplies k of the held experts at most
        moe_layers = self.num_layers - self.first_dense_layers
        inactive = moe_layers * per_expert * max(hi - lo - k, 0)
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# smoke/test shapes (reduced)
SMOKE_SHAPES: dict[str, ShapeConfig] = {
    "smoke_train": ShapeConfig("smoke_train", 32, 2, "train"),
    "smoke_decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
}

_REGISTRY: dict[str, "ModelConfig"] = {}
# the configurations the port registers and the JAX package does not: the
# tests that hold the port's registry to JAX's leave these out
PORT_ONLY = ("kimi-k2-instruct",)


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the config modules for their registration side effects
    from repro_torch.configs import (  # noqa: F401
        command_r_plus_104b,
        deepseek_7b,
        famous_bert,
        grok_1_314b,
        hubert_xlarge,
        kimi_k2_1t_a32b,
        kimi_k2_instruct,
        llava_next_34b,
        qwen2_7b,
        qwen3_32b,
        recurrentgemma_2b,
        rwkv6_1b6,
    )


def supported_cells(arch: str) -> list[str]:
    """Which of the four assigned shapes are well-defined for this arch."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        cells.append("decode_32k")
        if cfg.is_subquadratic:
            cells.append("long_500k")
    return cells


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Bundle of (arch, shape, parallelism) for a serving launch.

    ``tp`` is tensor parallelism on the "model" mesh axis (attention heads /
    kv heads / RWKV-6 heads / FFN and LRU hidden / MoE experts — see
    ``parallel.sharding.SERVE_TP_RULES``), ``dp``
    replica groups on "data".  ``tp == dp == 1`` means no mesh at all: the
    engine runs its unsharded single-device baseline.
    """
    arch: str
    shape: str = "smoke_decode"
    tp: int = 1
    dp: int = 1

    def __post_init__(self):
        assert self.tp >= 1 and self.dp >= 1, (self.tp, self.dp)

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.dp, self.tp)

    @property
    def needs_mesh(self) -> bool:
        return self.tp > 1 or self.dp > 1

    def make_mesh(self, device_type: str = "cuda"):
        """The (dp, tp) serving mesh over this process's group (one rank a
        process, see ``launch.mesh.make_serving_mesh``), or None when
        unsharded."""
        if not self.needs_mesh:
            return None
        from repro_torch.launch.mesh import make_serving_mesh
        return make_serving_mesh(tp=self.tp, dp=self.dp,
                                 device_type=device_type)


def shrink(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    unit = cfg.pattern_unit
    defaults = dict(
        name=cfg.name + "-smoke",
        num_layers=2 * len(unit) + len(cfg.tail_layers),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        lru_width=64 if cfg.lru_width else 0,
        window=min(cfg.window, 16) if cfg.window else 0,
        rwkv_head_dim=16,
    )
    defaults.update(over)
    return dataclasses.replace(cfg, **defaults)
