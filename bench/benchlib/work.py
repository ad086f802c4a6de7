"""The yardstick's arithmetic, frozen here so that a change to the program
cannot change it: the card's published peaks, each kernel's operations
and bytes from its shapes (copied from the port's ``kernels/work.py``),
the bytes a decode step needs and the model FLOPs of a token.

Everything takes plain numbers: a configuration file's ``model`` keys and
the shapes of a call.  Bytes count each input read once and each output
written once; operations are those the algorithm needs.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 rate.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def flash_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal mask keeps per row and head, queries
    being the last ``sq`` of ``sk`` positions."""
    # query i (of sq) sees keys 0 .. i + sk - sq
    return sq * (sk - sq + 1) + sq * (sq - 1) // 2


def flash(b: int, sq: int, sk: int, h: int, kh: int, dk: int, dv: int,
          es: int = 2) -> tuple:
    """K1 (causal prefill attention): q (b, sq, h, dk), k (b, sk, kh, dk),
    v (b, sk, kh, dv) read once, the output (b, sq, h, dv) written once;
    2 dk + 2 dv operations a kept pair.  Returns (ops, bytes)."""
    nbytes = (b * sq * h * dk + b * sk * kh * dk + b * sk * kh * dv
              + b * sq * h * dv) * es
    ops = 2 * b * h * (dk + dv) * flash_pairs(sq, sk)
    return ops, nbytes


def decode(b: int, live: int, h: int, kh: int, hd: int, es: int = 2) -> tuple:
    """K2 (decode attention) over ``live`` positions in each of ``b`` rows:
    q read and the output written once, the live K and V read once, the
    (b,) lengths read; 4 hd operations a (head, live position)."""
    nbytes = 2 * b * h * hd * es + 2 * b * live * kh * hd * es + b * 4
    return 4 * h * hd * b * live, nbytes


def time_bound(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the two."""
    return max(ops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


# ------------------------------------------------------------ the model
def _m(model: dict, key: str, default=None):
    v = model.get(key, default)
    if v is None:
        raise KeyError(key)
    return v


def layer_counts(model: dict) -> tuple:
    """(dense layers, MoE layers)."""
    n = _m(model, "num_hidden_layers")
    if model.get("n_routed_experts"):
        dense = min(n, model.get("first_k_dense_replace", 0))
        return dense, n - dense
    return n, 0


def attention_params(model: dict) -> int:
    """Weights of one attention mixer (products only)."""
    d = _m(model, "hidden_size")
    h = _m(model, "num_attention_heads")
    if model.get("kv_lora_rank"):
        qr, kr = model["q_lora_rank"], model["kv_lora_rank"]
        nope, rope, vd = (model["qk_nope_head_dim"], model["qk_rope_head_dim"],
                          model["v_head_dim"])
        return (d * qr + qr * h * (nope + rope) + d * (kr + rope)
                + kr * h * (nope + vd) + h * vd * d)
    kh = _m(model, "num_key_value_heads")
    hd = model.get("head_dim") or d // h
    return d * h * hd + 2 * d * kh * hd + h * hd * d


def attention_dims(model: dict) -> tuple:
    """(heads, query-key dim, value dim) of the attention core."""
    h = _m(model, "num_attention_heads")
    if model.get("kv_lora_rank"):
        return (h, model["qk_nope_head_dim"] + model["qk_rope_head_dim"],
                model["v_head_dim"])
    hd = model.get("head_dim") or model["hidden_size"] // h
    return h, hd, hd


def ffn_params(model: dict) -> int:
    d = _m(model, "hidden_size")
    return 3 * d * _m(model, "intermediate_size")


def expert_params(model: dict) -> int:
    return 3 * _m(model, "hidden_size") * _m(model, "moe_intermediate_size")


def moe_active_params(model: dict) -> int:
    """Weights one token's MoE layer multiplies by: the router, its k
    experts and the shared ones."""
    d = _m(model, "hidden_size")
    return (d * model["n_routed_experts"]
            + (model["num_experts_per_tok"] + model.get("n_shared_experts", 0))
            * expert_params(model))


def body_active_params(model: dict) -> int:
    """Weights one token multiplies by below the output head."""
    dense, moe = layer_counts(model)
    att = attention_params(model)
    total = dense * (att + ffn_params(model))
    if moe:
        total += moe * (att + moe_active_params(model))
    return total


def head_params(model: dict) -> int:
    return _m(model, "hidden_size") * _m(model, "vocab_size")


def model_flops(model: dict, n_tokens: int, start: int, logit_rows: int) -> float:
    """Model FLOPs of ``n_tokens`` consecutive positions of one sequence
    starting at position ``start`` (a prefill from 0, a decode step of one
    token at its position), with ``logit_rows`` rows through the output
    head: 2 a weight a token, and 2 (dk + dv) a head for each causal pair."""
    h, dk, dv = attention_dims(model)
    n_layers = _m(model, "num_hidden_layers")
    pairs = n_tokens * start + n_tokens * (n_tokens + 1) // 2
    return (2.0 * body_active_params(model) * n_tokens
            + 2.0 * head_params(model) * logit_rows
            + 2.0 * n_layers * h * (dk + dv) * pairs)


def cache_bytes_per_token(model: dict, es: int = 2) -> int:
    """Cache bytes one position holds over all layers."""
    n = _m(model, "num_hidden_layers")
    if model.get("kv_lora_rank"):
        return n * (model["kv_lora_rank"] + model["qk_rope_head_dim"]) * es
    h = _m(model, "num_attention_heads")
    hd = model.get("head_dim") or model["hidden_size"] // h
    return n * 2 * _m(model, "num_key_value_heads") * hd * es


def decode_step_bytes(model: dict, rows: int, live: int,
                      experts_touched: int, es: int = 2) -> int:
    """Bytes a decode step of ``rows`` tokens needs: every weight below
    and in the output head except the routed experts, the
    ``experts_touched`` routed experts of each MoE layer (the distinct
    experts the step's tokens route to), the tokens' embedding rows, and
    each row's ``live`` cached positions read (the new one written)."""
    dense, moe = layer_counts(model)
    d = _m(model, "hidden_size")
    att = attention_params(model)
    weights = dense * (att + ffn_params(model)) + head_params(model)
    if moe:
        shared = model.get("n_shared_experts", 0) * expert_params(model)
        weights += moe * (att + d * model["n_routed_experts"] + shared
                          + experts_touched * expert_params(model))
    norms = (2 * dense + 2 * moe + 1) * d
    return ((weights + norms + rows * d) * es
            + rows * live * cache_bytes_per_token(model, es))
