"""Model configuration system (a copy of ``repro.configs.base``).

Every architecture is a :class:`ModelConfig` registered under its id
(``--arch <id>``); a :class:`ShapeConfig` names a sequence length and
global batch (``--shape <name>``).  The registry holds the configs the
port has been brought up on.
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
    def num_units(self) -> int:
        return self.num_layers // len(self.pattern_unit)

    @property
    def tail_layers(self) -> tuple[str, ...]:
        n_tail = self.num_layers % len(self.pattern_unit)
        return self.pattern_unit[:n_tail]

    def param_count(self) -> int:
        """Total parameters (analytic, matches init)."""
        from repro_torch.models.module import count_params
        from repro_torch.models.transformer import model_spec

        return count_params(model_spec(self))


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
    from repro_torch.configs import famous_bert, qwen2_7b  # noqa: F401


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
