"""Mixture-of-experts FFN: shared + routed experts, top-k gating, capacity
dispatch (top-k FLOPs, no dense all-expert compute).

One call of ``ops.moe_route`` (K4) takes the router's logits to the whole
dispatch plan: the weights and experts of each token, each (token, choice)
pair's slot in the (E, C) grid, the token in each slot, and the softmax
probabilities and pairs summed by expert.  Padding experts (expert-parallel
divisibility, e.g. qwen2-moe 60 -> 64) are masked out of the softmax and
never receive tokens.

The plan is the reference's step for step, because which token a full
expert drops depends on it:

* capacity ``int(max(1, round(T * k * cf / E)))``, Python's ``round`` on
  the same float expression (at decode, B = 8 and cf = 2 give one slot an
  expert);
* a pair's position in its expert is the number of earlier tokens that
  picked it -- the reference's stable sort by expert, as a count, since a
  token picks an expert at most once -- and the pair is kept iff that is
  below capacity.  Every kept pair owns one slot.

So the reference's scatter of tokens into the (E, C, d) buffer is a row
gather through ``slot_tok`` (empty slots read a zero row), and its
scatter-add of the weighted expert outputs back to tokens is a gather
through ``slot`` and a sum over the k choices: no sort, no accumulating
index op, the same result on the card from call to call.  A dropped pair
reads a zero row placed after the expert outputs, so it adds exactly 0, as
the reference's ``where`` makes it, whatever the experts computed.  The aux
loss comes from the kernel's sums, and its gradient reaches the logits
through the probability sums, as the reference's does through ``probs``.

Gradients.  ``ops.moe_route`` differentiates the weights and the
probability sums (K4's backward kernel on the card).  The dispatch gather's
gradient is ``DispatchGather``'s gather through ``slot``, summed over the k
choices in a fixed order, so two backward passes on the same inputs give
the same bits and a resumed run repeats an uninterrupted one.

The expert products ``ecd,edf->ecf`` are batched matrix products, which the
reference also leaves to its compiler.  Every expert's weights are read at
every call, as the reference's (E, C, d) buffer does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import whole, whole_grad
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


class DispatchGather(torch.autograd.Function):
    """Rows of x (T, d) into the slots (E C, d): slot s reads token
    ``slot_tok[s]``, an empty slot (T) the zero row after the tokens.  Its
    gradient gathers each token's k slot rows through ``slot`` (a dropped
    pair, E C, reads a zero row) and sums them over k in order, in float32:
    the transpose of the gather without ``index_add_``, whose atomic adds
    on the card would sum a token's rows in another order from call to
    call."""

    @staticmethod
    def forward(ctx, x, slot_tok, slot):
        ctx.save_for_backward(slot)
        xz = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return xz.index_select(0, slot_tok.reshape(-1))

    @staticmethod
    def backward(ctx, dbuf):
        (slot,) = ctx.saved_tensors
        t, k = slot.shape
        dz = torch.cat([dbuf, dbuf.new_zeros((1, dbuf.shape[1]))])
        rows = dz.index_select(0, slot.reshape(-1)).reshape(t, k, -1).float()
        dx = rows[:, 0]
        for j in range(1, k):
            dx = dx + rows[:, j]
        return dx.to(dbuf.dtype), None, None


def moe_forward(cfg, p, x, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.routed_total()
    xf = x.reshape(t, d)

    logits = xf @ p["router"]["w"].to(xf.dtype)                     # (T, E)
    sharded = isinstance(xf, DTensor)
    if sharded:
        return _moe_sharded(cfg, p, x, xf, logits, capacity_factor)
    cap = capacity(t, m.top_k, capacity_factor, e)
    r = ops.moe_route(logits, m.top_k, capacity=cap, n_valid=m.n_routed,
                      router_scale=m.router_scale)

    # load-balance aux loss (Switch-style) over the valid experts:
    # n_routed * sum_e mean_t(probs) * mean_t(picks)
    aux = (r.prob_sum * r.counts).sum() * (m.n_routed / (t * t))

    # ---- dispatch: slot (e, c) holds token slot_tok[e, c]; T, an empty
    # slot, reads the zero row after the tokens
    buf = DispatchGather.apply(xf, r.slot_tok, r.slot).reshape(e, cap, d)

    # ---- expert compute (E, C, d) -> (E, C, d), above one zero row.
    # Without a gradient the down product writes straight into the rows
    # (no copy); ``out=`` records no gradient, so training concatenates.
    w_exp = p["experts"]
    h = F.silu(torch.bmm(buf, w_exp["gate"].to(buf.dtype)))
    h = h * torch.bmm(buf, w_exp["up"].to(buf.dtype))
    down = w_exp["down"].to(buf.dtype)
    if torch.is_grad_enabled() and (h.requires_grad or down.requires_grad):
        yexp = torch.cat([torch.bmm(h, down).view(e * cap, d),
                          xf.new_zeros((1, d))])
    else:
        yexp = xf.new_empty((e * cap + 1, d))
        yexp[-1].zero_()
        torch.bmm(h, down, out=yexp[:-1].view(e, cap, d))

    # ---- combine: each token's k rows (a dropped pair's is the zero row),
    # weighted and summed over k by one (1, k) x (k, d) product a token.
    # The product sums the k terms in its own order and rounds once; the
    # reference adds the pairs one by one in its sorted order instead.
    rows = yexp.index_select(0, r.slot.reshape(-1)).reshape(t, m.top_k, d)
    y = torch.bmm(r.weights.to(xf.dtype)[:, None, :], rows)[:, 0]

    if "shared" in p:
        y = y + L.swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux


def _combine(yexp, slot, weights):
    """Each token's k expert-output rows (E, C, d) through ``slot`` (a
    dropped pair's, E C, the zero row after them), weighted and summed
    over k, as ``moe_forward`` combines them."""
    e, cap, d = yexp.shape
    t, k = slot.shape
    yz = torch.cat([yexp.reshape(e * cap, d), yexp.new_zeros((1, d))])
    rows = yz.index_select(0, slot.reshape(-1)).reshape(t, k, d)
    return torch.bmm(weights.to(yexp.dtype)[:, None, :], rows)[:, 0]


def _moe_sharded(cfg, p, x, xf, logits, capacity_factor):
    """``moe_forward`` on DTensors (a sharded program): the plan of the
    unsharded layer, over every token of the step, since which token a
    full expert drops depends on all of them (the reference's plan is one
    sort over the global batch).  The logits and token rows are gathered
    whole over the ranks of the tokens and every rank runs K4 on all of
    them (its plan, capacity and aux-loss sums are the unsharded ones);
    each rank gathers the tokens into the whole (E, C, d) slot buffer
    under ``local_map`` and keeps its share of the slots (C cut over the
    ranks of the tokens, a local slice) for the expert products, which
    run on DTensors whose rules move the expert weights (an all-gather of
    their FSDP shards, or of the other model ranks' experts under expert
    parallelism).  The expert outputs are gathered whole again and every
    rank combines every token, then keeps its own rows.  Each computation
    under ``local_map`` is thus the same on every rank, so the gradients
    of its replicated inputs are replicated too (a combine of one rank's
    tokens alone would leave each rank a part of the expert outputs'
    gradient, a partial sum that ``local_map`` would read as whole).  The
    cost beside the unsharded layer: an all-gather of the logits, the rows
    and the expert outputs; K4 and the combine on every token on every
    rank."""
    m = cfg.moe
    b, s, d = x.shape
    t, e = logits.shape
    rows = ops.row_placements(xf)
    row_dims = [n for n, pl in enumerate(rows) if pl.is_shard(0)]
    cap = capacity(t, m.top_k, capacity_factor, e)
    r = ops.moe_route(whole(logits, 0), m.top_k, capacity=cap,
                      n_valid=m.n_routed, router_scale=m.router_scale)
    aux = (r.prob_sum * r.counts).sum() * (m.n_routed / (t * t))
    xw = [Replicate() if pl.is_partial() or pl.is_shard(0) else pl
          for pl in xf.placements]
    slots_w = [Shard(2) if pl.is_shard(1) else pl for pl in xw]
    repl = [Replicate()] * len(xw)
    buf = ops.on_shards(
        lambda x, st, sl: DispatchGather.apply(x, st, sl).reshape(e, cap, -1),
        (xw, repl, repl), slots_w, xf, r.slot_tok, r.slot)
    buf = buf.redistribute(buf.device_mesh, [
        Shard(1) if n in row_dims else pl for n, pl in enumerate(slots_w)])
    w_exp = p["experts"]
    h = F.silu(torch.bmm(buf, w_exp["gate"].to(buf.dtype)))
    h = h * torch.bmm(buf, w_exp["up"].to(buf.dtype))
    yexp = torch.bmm(h, w_exp["down"].to(buf.dtype))
    yw = [Shard(2) if pl.is_shard(2) else Replicate()
          for pl in yexp.placements]
    tw = [Shard(1) if pl.is_shard(2) else Replicate() for pl in yw]
    y = ops.on_shards(_combine, (yw, repl, repl), tw, yexp, r.slot,
                      r.weights)
    y = y.redistribute(y.device_mesh, [rows[n] if n in row_dims else pl
                                       for n, pl in enumerate(tw)])
    y = whole_grad(y.reshape(b, s, d), 1)
    if "shared" in p:       # on (B, S, d): DTensor cannot view every layout
        y = y + L.swiglu(p["shared"], x)           # of its output back
    return y, aux
