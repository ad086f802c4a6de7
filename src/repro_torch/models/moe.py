"""Mixture-of-experts FFN: shared + routed experts, top-k gating, capacity
dispatch (sort + scatter: top-k FLOPs, no dense all-expert compute).

The router runs the MoE router kernel (``ops.moe_topk``, K4).  Padding
experts (expert-parallel divisibility, e.g. qwen2-moe 60 -> 64) are masked
out of the softmax and never receive tokens.

Dispatch follows the reference step for step, because which token a full
expert drops depends on it:

* capacity ``int(max(1, round(T * k * cf / E)))``, Python's ``round`` on
  the same float expression (at decode, B = 8 and cf = 2 give one slot an
  expert);
* a stable sort of the (token, choice) pairs by expert, so the tokens an
  expert keeps are its first ``capacity`` in token order;
* dropped pairs add zeros at slot 0 of their expert (``index_put_`` with
  ``accumulate``), and the weighted expert outputs are summed back per token
  with ``index_add_``, whose order of summation on CUDA can vary from run
  to run, so results on the card agree to a tolerance, not bit for bit.

The expert products ``ecd,edf->ecf`` are batched matrix products, which the
reference also leaves to its compiler.  Every expert's weights are read at
every call, as the reference's (E, C, d) buffer does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L


def moe_init(gen, cfg, lead: tuple = ()):
    m = cfg.moe
    e = m.routed_total()
    d, f = cfg.d_model, m.expert_ff
    p = {
        "router": {"w": L._normal(gen, (*lead, d, e), 0.02, cfg.dtype)},
        "experts": {
            "gate": L._normal(gen, (*lead, e, d, f), 1.0 / np.sqrt(d), cfg.dtype),
            "up": L._normal(gen, (*lead, e, d, f), 1.0 / np.sqrt(d), cfg.dtype),
            "down": L._normal(gen, (*lead, e, f, d), 1.0 / np.sqrt(f), cfg.dtype),
        },
    }
    if m.n_shared > 0:
        p["shared"] = L.swiglu_init(gen, d, m.n_shared * f, cfg.dtype, lead=lead)
    return p


def capacity(t: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Slots per expert for ``t`` tokens, as the reference computes them."""
    return int(max(1, round(t * top_k * capacity_factor / n_experts)))


def moe_forward(cfg, p, x, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.routed_total()
    xf = x.reshape(t, d)

    logits = xf @ p["router"]["w"].to(xf.dtype)                     # (T, E)
    weights, idx = ops.moe_topk(logits, m.top_k, n_valid=m.n_routed)
    weights = weights * m.router_scale

    # load-balance aux loss (Switch-style) over the valid experts
    valid = torch.arange(e, device=x.device) < m.n_routed
    probs = torch.softmax(torch.where(valid, logits.float(), -1e30), dim=-1)
    me = probs.mean(dim=0)                                          # (E,)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx.reshape(-1).long(),
                      torch.ones(t * m.top_k, device=x.device))
    aux = m.n_routed * torch.sum(me * counts / t)

    # ---- capacity dispatch: sort tokens by expert, scatter to (E, C, d)
    cap = capacity(t, m.top_k, capacity_factor, e)
    flat_eid = idx.reshape(-1).long()                               # (T*k,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    order = torch.argsort(flat_eid, stable=True)
    eid_s, tok_s, w_s = flat_eid[order], flat_tok[order], flat_w[order]
    # position of each routed token within its expert's block: its index
    # minus the index of the expert's first entry in the sorted list
    pos_s = (torch.arange(t * m.top_k, device=x.device)
             - torch.searchsorted(eid_s, eid_s))
    keep = pos_s < cap                                              # drop overflow
    slot = torch.where(keep, pos_s, 0)
    buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=x.device)
    buf.index_put_((eid_s, slot),
                   torch.where(keep[:, None], xf[tok_s], 0.0), accumulate=True)

    # ---- expert compute (E, C, d) -> (E, C, d)
    w_exp = p["experts"]
    h = F.silu(torch.bmm(buf, w_exp["gate"].to(buf.dtype)))
    h = h * torch.bmm(buf, w_exp["up"].to(buf.dtype))
    yexp = torch.bmm(h, w_exp["down"].to(buf.dtype))

    # ---- combine back, weighted
    gathered = torch.where(keep[:, None], yexp[eid_s, slot], 0.0) \
        * w_s[:, None].to(xf.dtype)
    y = torch.zeros_like(xf).index_add_(0, tok_s, gathered)

    if "shared" in p:
        y = y + L.swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux
