"""deepseek-v3-671b [moe] -- 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8 -- MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf]

Interpretation of the assigned numbers against the public config:
* d_ff=2048 is the per-expert (and shared-expert) intermediate size
  (``moe_intermediate_size``); the 3 leading dense layers use 18432
  (``intermediate_size``), per the HF config.
* MLA dims from the public config: q_lora 1536, kv_lora 512, nope 128,
  rope 64, v 128.
* MTP (multi-token prediction, depth 1) is implemented as an optional extra
  scan block + head, enabled for training configs.
"""
from .base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                # dense-layer FF (first_k_dense layers)
    vocab_size=129280,
    head_dim=192,              # qk_nope (128) + qk_rope (64)
    first_k_dense=3,
    moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, expert_ff=2048,
                  n_expert_groups=8, router_scale=2.5),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=10_000.0,
))
