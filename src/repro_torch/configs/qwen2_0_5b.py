"""qwen2-0.5b [dense] -- 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 -- GQA, QKV bias [arXiv:2407.10671; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
