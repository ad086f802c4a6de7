"""Plain PyTorch versions of the port's kernels: dense attention, float32
inside, cast back to the input type.  The CPU path runs them; on the card
they are what each kernel is held against.

Both take the model's layout, q (B, S, H, hd) and k, v (B, Sk, KH, hd)
with query head ``h`` reading KV head ``h // G``; ``ops`` serves the
reference package's (BH, S, D) signatures through them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def grouped_flash_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      scale: float | None = None):
    """Dense softmax attention. q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kh, h // kh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    qpos = (torch.arange(sq, device=q.device)[:, None]
            + (sk - sq if causal else 0))
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def grouped_decode_ref(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd); lengths: (B,) live lengths."""
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(b, kh, h // kh, hd)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] < lengths.to(q.device)[:, None]         # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
