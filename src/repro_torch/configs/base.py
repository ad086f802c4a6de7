"""Architecture configs and input-shape registry.

Every assigned architecture gets an :class:`ArchConfig` built from the exact
public numbers in the assignment (see per-arch modules), plus a REDUCED
config of the same family for CPU smoke tests. Input shapes are the four
assigned cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int               # routed experts
    n_shared: int               # shared (always-on) experts
    top_k: int
    expert_ff: int              # per-expert intermediate size
    n_expert_groups: int = 1    # group-limited routing (deepseek)
    router_scale: float = 1.0
    padded_routed: int = 0      # routed experts padded for EP divisibility

    def routed_total(self) -> int:
        return self.padded_routed or self.n_routed


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16          # mamba state size per channel
    conv_width: int = 4
    expand: int = 2
    slstm_every: int = 0         # xlstm: every k-th block is sLSTM (0 = none)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    first_k_dense: int = 0       # leading dense layers in MoE stacks
    # hybrid / attention structure
    sliding_window: int = 0      # 0 = full attention everywhere
    global_attn_layers: tuple = ()   # layers that stay full-attn despite SWA
    parallel_ssm: bool = False   # hymba: attention and SSM heads in parallel
    # enc-dec / multimodal frontends (stubs provide embeddings)
    encoder_layers: int = 0
    encoder_len: int = 1024      # stub frame/patch sequence length
    vision_tokens: int = 0       # vlm prefix tokens
    # training
    dtype: str = "bfloat16"
    remat: bool = True
    # misc
    max_position: int = 1 << 20

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def attention_kind(self) -> str:
        if self.mla is not None:
            return "mla"
        return "gqa"

    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context (long_500k cell)?"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.sliding_window > 0:
            return True
        return False

    def has_decoder(self) -> bool:
        return True   # none of the assigned archs is encoder-only

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 + self.first_k_dense),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            dtype="float32",
            remat=False,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_len=16,
            vision_tokens=min(self.vision_tokens, 8),
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            global_attn_layers=tuple(g for g in self.global_attn_layers if g < 2),
            first_k_dense=min(self.first_k_dense, 1),
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, n_routed=4, n_shared=min(self.moe.n_shared, 1),
                                top_k=2, expert_ff=32, n_expert_groups=1, padded_routed=4)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, state_dim=4)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(_REGISTRY)}")


def all_archs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    from . import (stablelm_3b, llama3_2_1b, qwen2_0_5b, granite_8b,          # noqa: F401
                   seamless_m4t_medium, hymba_1_5b, internvl2_1b,
                   qwen2_moe_a2_7b, deepseek_v3_671b, xlstm_350m)


def cells(include_skipped: bool = False):
    """All (arch x shape) dry-run cells; long_500k only for sub-quadratic
    archs unless include_skipped."""
    out = []
    for name in all_archs():
        cfg = get_arch(name)
        for sname, shape in SHAPES.items():
            skipped = (sname == "long_500k" and not cfg.is_subquadratic())
            if skipped and not include_skipped:
                continue
            out.append((name, sname, skipped))
    return out
