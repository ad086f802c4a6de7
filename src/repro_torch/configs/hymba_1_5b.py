"""hymba-1.5b [hybrid] -- 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 -- parallel attn+mamba heads [arXiv:2411.13676; hf]

Hymba fuses attention heads and mamba (SSM) heads *in parallel* within each
block, with sliding-window attention in all but three global layers
(first / middle / last) -- which keeps it sub-quadratic and long_500k-capable.
"""
from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    parallel_ssm=True,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    rope_theta=10_000.0,
))
