"""qwen2-moe-a2.7b [moe] -- 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 -- 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 routed experts are padded to 64 for clean expert-parallel sharding over
the 16-way model axis (padding experts receive -inf router logits and zero
weights; they are never selected). Recorded in DESIGN.md section 9.
"""
from .base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # per-expert intermediate (assignment d_ff)
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, expert_ff=1408,
                  padded_routed=64),
    rope_theta=1_000_000.0,
))
