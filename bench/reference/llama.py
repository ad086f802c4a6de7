"""Plain reference of a Llama-architecture decoder as its published
``config.json`` states it: float32 with TF32 off, plain ``torch``
operations, no kernel, cache or batching.  It imports nothing of the
program.

Per layer: RMSNorm, grouped-query attention (``num_attention_heads`` query
heads over ``num_key_value_heads`` KV heads) with rotary embeddings (base
``rope_theta``, the rotation applied to the two halves of each head),
causal softmax, the output projection and the residual; RMSNorm and the
SwiGLU MLP (down(silu(gate x) * up x)) and the residual.  A final RMSNorm
and the untied output head.  Weights are stored (d_in, d_out) and applied
x @ w.  A configuration with biases, tied embeddings or scaled RoPE is
refused: this reference does not compute those models.

``quant="fp8"`` is the control: every weight matrix and every product's
input rounded to float8 e4m3 (per output channel and per row scales) and
back, the rest as above.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(x, dim):
    """Round to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ops:
    """The products and norms, in float32 or through the fp8 control."""

    def __init__(self, quant=None):
        self.quant = quant

    def w(self, t):
        t = t.float()
        return _fp8(t, -2) if self.quant == "fp8" else t

    def mm(self, x, w):
        if self.quant == "fp8":
            x = _fp8(x, -1)
        return x @ self.w(w)

    @staticmethod
    def rmsnorm(x, g, eps):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * g.float()


def rope(x, positions, theta):
    """x (S, heads, hd): rotate (x1, x2) halves by position * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = positions[:, None].double() * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale, block: int = 1024):
    """q (S, H, dk), k (S, KH, dk), v (S, KH, dv): each query attends to
    the keys at its position and before; query head h reads KV head
    h // (H / KH).  Computed in blocks of queries."""
    s, h, _ = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = []
    kpos = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        qb = q[a:a + block]
        sc = torch.einsum("qhd,khd->hqk", qb, k) * scale
        qpos = torch.arange(a, a + qb.shape[0], device=q.device)
        sc = sc.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                            float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v))
    return torch.cat(out)


def logits(model: dict, weights: dict, tokens, first: int, *, quant=None):
    """Logits (float32) at positions ``first`` .. end of the sequence
    ``tokens`` (int64, on the weights' device): row j predicts the token
    after position ``first + j``."""
    for key in ("attention_bias", "mlp_bias", "tie_word_embeddings",
                "rope_scaling"):
        if model.get(key):
            raise NotImplementedError(f"{key} is {model[key]!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = Ops(quant)
    d = model["hidden_size"]
    h, kh = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model.get("head_dim") or d // h
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = weights["embed"]["table"][tokens].float()
    for lp in weights["layers"]:
        a = lp["attn"]
        xn = o.rmsnorm(x, lp["norm1"]["g"], eps)
        q = o.mm(xn, a["wq"]["w"]).view(-1, h, hd)
        k = o.mm(xn, a["wk"]["w"]).view(-1, kh, hd)
        v = o.mm(xn, a["wv"]["w"]).view(-1, kh, hd)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        att = causal_attention(q, k, v, hd ** -0.5)
        x = x + o.mm(att.reshape(-1, h * hd), a["wo"]["w"])
        f = lp["ffn"]
        xn = o.rmsnorm(x, lp["norm2"]["g"], eps)
        hmid = torch.nn.functional.silu(o.mm(xn, f["gate"]["w"])) \
            * o.mm(xn, f["up"]["w"])
        x = x + o.mm(hmid, f["down"]["w"])
    x = o.rmsnorm(x[first:], weights["final_norm"]["g"], eps)
    return o.mm(x, weights["lm_head"]["w"])
