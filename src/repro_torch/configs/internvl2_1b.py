"""internvl2-1b [vlm] -- 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 -- InternViT + InternLM2/Qwen2 backbone [arXiv:2404.16821; hf]

The InternViT vision frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (batch, vision_tokens, d_model) which are
prepended to the token embedding sequence; the LM backbone is full.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    vision_tokens=256,
    rope_theta=1_000_000.0,
))
