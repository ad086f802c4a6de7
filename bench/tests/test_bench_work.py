"""The frozen work formulas on shapes whose counts are worked out here by
hand."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchlib import work  # noqa: E402

TINY = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
        "vocab_size": 10}
TINY_MOE = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 3,
            "first_k_dense_replace": 1, "num_attention_heads": 2,
            "num_key_value_heads": 2, "vocab_size": 10, "q_lora_rank": 4,
            "kv_lora_rank": 2, "qk_nope_head_dim": 3, "qk_rope_head_dim": 1,
            "v_head_dim": 2, "n_routed_experts": 4, "num_experts_per_tok": 2,
            "n_shared_experts": 1, "moe_intermediate_size": 5}


def test_causal_pairs():
    assert work.flash_pairs(4, 4) == 1 + 2 + 3 + 4
    assert work.flash_pairs(2, 5) == 4 + 5          # queries are the last two


def test_flash_ops_and_bytes():
    ops, nbytes = work.flash(b=1, sq=4, sk=4, h=2, kh=1, dk=4, dv=4)
    assert ops == 2 * 1 * 2 * (4 + 4) * 10
    # q 1*4*2*4, k 1*4*1*4, v 1*4*1*4, out 1*4*2*4 elements of 2 bytes
    assert nbytes == (32 + 16 + 16 + 32) * 2


def test_decode_ops_and_bytes():
    ops, nbytes = work.decode(b=2, live=5, h=4, kh=2, hd=8)
    assert ops == 4 * 4 * 8 * 2 * 5
    assert nbytes == 2 * 2 * 4 * 8 * 2 + 2 * 2 * 5 * 2 * 8 * 2 + 2 * 4


def test_time_bound_takes_the_larger_term():
    assert work.time_bound(989e12, 0) == pytest.approx(1.0)
    assert work.time_bound(0, 3.35e12) == pytest.approx(1.0)


def test_dense_params_and_flops():
    # attention: wq 8x8, wk 8x4, wv 8x4, wo 8x8; ffn 3 x 8 x 16
    assert work.attention_params(TINY) == 64 + 32 + 32 + 64
    assert work.body_active_params(TINY) == 2 * (192 + 384)
    # 3 tokens from position 0, one logit row: 6 causal pairs a head
    f = work.model_flops(TINY, 3, 0, 1)
    assert f == 2 * 1152 * 3 + 2 * 80 + 2 * 2 * 2 * (4 + 4) * 6
    # one token at position 5 sees 6 positions
    assert work.model_flops(TINY, 1, 5, 1) == 2 * 1152 + 2 * 80 \
        + 2 * 2 * 2 * 8 * 6


def test_mla_moe_params():
    # q_a 8x4, q_b 4x(2*4), kv_a 8x(2+1), kv_b 2x(2*(3+2)), o (2*2)x8
    assert work.attention_params(TINY_MOE) == 32 + 32 + 24 + 20 + 32
    assert work.expert_params(TINY_MOE) == 3 * 8 * 5
    # router 8x4 and (2 + 1) experts
    assert work.moe_active_params(TINY_MOE) == 32 + 3 * 120
    assert work.layer_counts(TINY_MOE) == (1, 2)
    assert work.attention_dims(TINY_MOE) == (2, 4, 2)


def test_decode_step_bytes_count_only_the_routed_experts():
    dense = (work.attention_params(TINY_MOE) + 3 * 8 * 16)
    moe_fixed = work.attention_params(TINY_MOE) + 32 + 120
    norms = (2 * 1 + 2 * 2 + 1) * 8
    live_cache = 3 * (2 + 1)             # latent + rope a position a layer
    got = work.decode_step_bytes(TINY_MOE, rows=1, live=7, experts_touched=2,
                                 es=2)
    want = (dense + 2 * (moe_fixed + 2 * 120) + 80 + norms + 8) * 2 \
        + 7 * live_cache * 2
    assert got == want
    assert work.decode_step_bytes(TINY_MOE, 1, 7, 4) - got == 2 * 2 * 120 * 2


def test_cache_bytes_per_token():
    assert work.cache_bytes_per_token(TINY) == 2 * 2 * 1 * 4 * 2
    # granite-8b: 36 x 8 x 128 x 2 x 2 B = 147,456 B
    g = {"num_hidden_layers": 36, "num_attention_heads": 32,
         "num_key_value_heads": 8, "head_dim": 128, "hidden_size": 4096}
    assert work.cache_bytes_per_token(g) == 147456
