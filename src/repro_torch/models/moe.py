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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
    call.  The sharded layer's exchange (``_routed_local``) gathers its
    buffers the same way, each with its own index and inverse."""

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
    y = _weighted_sum(rows, r.weights)

    if "shared" in p:
        y = y + L.swiglu(p["shared"], xf)
    return y.reshape(b, s, d), aux


def _moe_sharded(cfg, p, x, xf, logits, capacity_factor):
    """``moe_forward`` on DTensors (a sharded program): the unsharded
    layer's plan, with each routed row moved only to the rank that
    computes its slot and each expert output only back to the rank that
    holds its token, by two all-to-alls of static size.

    The plan.  Which pair a full expert drops depends on every token of the
    step (the reference sorts over the global batch), so the logits (T, E)
    are gathered whole and every rank runs K4 on every token: its ``slot``,
    ``slot_tok``, capacity and aux-loss sums are the unsharded layer's.

    Placements (``_Layout``).  The tokens stay where they are: T cut over
    the row dims (the data axes that cut the batch, D ranks; a data axis
    of size 1 joins them, so one rank issues the same collectives), and d
    cut over the model axis (M ranks) as the residual stream arrives
    (M_g = M), or whole (M_g = 1).  The slots (E, C, d) are cut C over the
    row dims (C padded to D C_l, the padding empty) and E over the model
    axis (E_l = E / M) whenever the experts are cut over it and E divides:
    under expert parallelism (EP) each rank then computes its own experts,
    and under expert-TP (the FF dim cut) the E_l experts' slots are
    gathered over the model axis before the products and their partial
    outputs reduce-scattered back after them.  The products are
    ``torch.bmm`` on each rank's (E_l, C_l, d) block (expert-TP: (E, C_l,
    d)) with its own weights, gathered over the data axes as FSDP does.

    The exchange (``_routed_local``), over the row dims and, when M_g = M,
    the model axis: each rank sends every rank of that group one block of
    E_l C_l rows of d / M_g (the receiver's slots, filled with the sender's
    own tokens' rows, columns its own, zeros elsewhere), and sums what it
    receives over the senders (each slot has one); the outputs go back the
    same way, each block holding only the receiver's tokens' rows.  With
    M_g = 1 each rank then holds its tokens' rows for its own experts (or
    their partial sums over its FF slice, where E does not divide), which
    an all-reduce over the model axis completes (under EP a sum of one
    value and zeros, exact).  Each rank then combines its own tokens, by
    ``_weighted_sum`` as the unsharded layer does.  Every gather has a
    gather for its gradient (``DispatchGather``): no ``index_add_``, no
    atomics, the same bits from call to call.

    Bytes a rank sends, and receives, in one all-to-all, at the
    activations' ``s`` bytes an element (``exchange_bytes``):

        E_l * D * ceil(C / D) * d * s,   C = round(T k cf / E),

    two a layer's forward and two its backward (the reverse exchange).
    Besides: the logits' all-gather (T E elements); under expert-TP the
    slots' all-gather over the model axis (E C_l d) and its
    reduce-scatter (E_l C_l d); with M_g = 1 and the experts cut, the
    all-reduce of (T / D, k, d); and the experts' FSDP gathers.

    Gradients.  Each rank computes a part, so ``local_map`` is told how
    each input's gradient is placed: the token rows' is partial over the
    model axis when M_g = 1 and the experts are cut over it (each rank
    sent only its experts' pairs, or computed its FF slice), else placed
    as the rows; an expert weight's is partial over the row dims (each
    rank's slots hold other tokens); the combine weights' is partial over
    the model axis when M_g = M (each rank combines its own columns).  The
    all-to-all's gradient is the reverse all-to-all, the all-gather's a
    reduce-scatter and back, and the all-reduce's the identity (its output
    is replicated, so its gradient arrives whole)."""
    m = cfg.moe
    b, s, d = x.shape
    t, e = logits.shape
    cap = capacity(t, m.top_k, capacity_factor, e)
    r = ops.moe_route(whole(logits, 0), m.top_k, capacity=cap,
                      n_valid=m.n_routed, router_scale=m.router_scale)
    aux = (r.prob_sum * r.counts).sum() * (m.n_routed / (t * t))
    experts = tuple(p["experts"][n] for n in ("gate", "up", "down"))
    lay = _Layout.of(xf, experts[0], e, d)
    w_in, w_grad = lay.experts(experts)
    y = ops.on_shards(
        lambda *a: _routed_local(lay, e, cap, *a),
        (lay.x, lay.rows_pl, lay.repl, lay.rows_pl) + w_in,
        lay.x, xf, r.slot, r.slot_tok, r.weights, *experts,
        grad_placements=(lay.x_grad, lay.rows_pl, lay.repl, lay.weights_grad)
        + w_grad)
    y = whole_grad(y.reshape(b, s, d), 1)
    if "shared" in p:       # on (B, S, d): DTensor cannot view every layout
        y = y + L.swiglu(p["shared"], x)           # of its output back
    return y, aux


def _weighted_sum(rows, weights):
    """Each token's k rows (T, k, d) weighted and summed over k by one
    (1, k) x (k, d) product a token: the combine of ``moe_forward``."""
    return torch.bmm(weights.to(rows.dtype)[:, None, :], rows)[:, 0]


def exchange_bytes(t: int, top_k: int, capacity_factor: float,
                   n_experts: int, d: int, itemsize: int, rows: int,
                   expert_parts: int = 1) -> int:
    """Bytes a rank sends, and receives, in one all-to-all of the sharded
    layer (``_moe_sharded``): ``t`` tokens of the step, their rows cut over
    ``rows`` ranks, the experts over ``expert_parts`` (the model axis when
    the expert weights are cut over it and E divides, else 1)."""
    c_l = -(-capacity(t, top_k, capacity_factor, n_experts) // rows)
    return n_experts // expert_parts * rows * c_l * d * itemsize


class _Layout:
    """Where ``_moe_sharded`` puts the tokens, the slots and the experts on
    a mesh (its docstring says why): ``rows`` the mesh dims that cut T,
    ``split`` the mesh dim that cuts the expert weights (their expert dim
    under EP, ``ep``, else their FF dim), ``cut`` whether the exchange
    cuts E over it, ``cols`` that dim when d is cut over it in the
    exchange too; each ``*_pl`` a placement list for ``local_map``."""

    def __init__(self, mesh, rows, split, ep, cut, cols):
        self.mesh, self.rows, self.split = mesh, rows, split
        self.ep, self.cut, self.cols = ep, cut, cols
        n = mesh.ndim
        self.repl = [Replicate()] * n
        self.rows_pl = [Shard(0) if i in rows else Replicate()
                        for i in range(n)]
        self.x = [Shard(1) if i == cols else pl
                  for i, pl in enumerate(self.rows_pl)]
        part = cols is None and split is not None
        self.x_grad = [Partial() if i == split and part else pl
                       for i, pl in enumerate(self.x)]
        self.weights_grad = [Partial() if i == cols else pl
                             for i, pl in enumerate(self.rows_pl)]

    @classmethod
    def of(cls, xf, gate, e: int, d: int):
        """The layout for token rows ``xf`` (T, d) and an expert weight
        ``gate`` (E, d, f) as they arrive, E experts."""
        mesh = xf.device_mesh
        split, ep = None, False
        if isinstance(gate, DTensor):
            for i, pl in enumerate(gate.placements):
                dim = pl.dim % gate.ndim if pl.is_shard() else None
                if dim in (gate.ndim - 3, gate.ndim - 1):
                    split, ep = i, dim == gate.ndim - 3
        rows = tuple(
            i for i, pl in enumerate(xf.placements) if i != split and (
                pl.is_shard(0) or mesh.size(i) == 1
                and mesh.mesh_dim_names[i] in ("pod", "data")))
        if split is not None and any(i > split for i in rows):
            raise ValueError("moe: the experts' mesh dim must follow the "
                             "token rows' dims")
        cut = split is not None and e % mesh.size(split) == 0
        cols = split if cut and d % mesh.size(split) == 0 and \
            not xf.placements[split].is_replicate() else None
        return cls(mesh, rows, split, ep, cut, cols)

    def experts(self, weights) -> tuple:
        """The expert weights' (gate, up, down) placements under
        ``local_map`` -- cut on their expert or FF dim over ``split`` as
        they are, gathered over every other mesh dim -- and their
        gradients' (partial over the row dims)."""
        keep, grad = [], []
        for w, f_dim in zip(weights, (-1, -1, -2)):
            if not isinstance(w, DTensor):
                keep.append(None)
                grad.append(None)
                continue
            pl = [p if i == self.split and p.is_shard() and p.dim % w.ndim
                  in (w.ndim - 3, w.ndim + f_dim) else Replicate()
                  for i, p in enumerate(w.placements)]
            keep.append(pl)
            grad.append([Partial() if i in self.rows else p
                         for i, p in enumerate(pl)])
        return tuple(keep), tuple(grad)

    def sizes(self) -> tuple:
        """(D, M, M_g): ranks that cut T, that cut the experts, that cut d
        in the exchange."""
        dr = 1
        for i in self.rows:
            dr *= self.mesh.size(i)
        mm = 1 if self.split is None else self.mesh.size(self.split)
        return dr, mm, (mm if self.cols is not None else 1)

    def coords(self) -> tuple:
        """This rank's (row block, model rank)."""
        i = 0
        for dim in self.rows:
            i = i * self.mesh.size(dim) + self.mesh.get_local_rank(dim)
        j = 0 if self.split is None else self.mesh.get_local_rank(self.split)
        return i, j

    def group(self):
        """The exchange's group: the row dims and ``cols``, flattened in
        mesh order (None when there are none)."""
        dims = self.rows + ((self.cols,) if self.cols is not None else ())
        if not dims:
            return None
        if len(dims) == 1:
            return self.mesh.get_group(dims[0])
        # the flattened mesh holds a real tensor of ranks, made outside the
        # dry-run's fake mode
        from torch.utils._python_dispatch import _disable_current_modes
        names = tuple(self.mesh.mesh_dim_names[i] for i in dims)
        with _disable_current_modes():
            return self.mesh[names]._flatten().get_group()


def _fc():
    from torch.distributed import _functional_collectives as fc
    return fc


def _all_to_all(x, group):
    return _fc().wait_tensor(_fc().all_to_all_single(x, None, None, group))


def _all_gather(x, group):
    return _fc().wait_tensor(_fc().all_gather_tensor(x, 0, group))


def _reduce_scatter(x, group):
    return _fc().wait_tensor(_fc().reduce_scatter_tensor(x, "sum", 0, group))


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal blocks over ``group``; its gradient
    is the same exchange of the gradient (the reverse)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """The blocks of ``group``'s ranks stacked on dim 0; its gradient is
    each rank's block of the gradients summed (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad.contiguous(), ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """The sum over ``group`` of its ranks' tensors, each rank keeping its
    block of dim 0; its gradient is the blocks' gradients stacked (an
    all-gather)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad.contiguous(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    """A sum over ``group`` whose output every rank holds whole, so its
    gradient arrives whole: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _fc().wait_tensor(_fc().all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _routed_local(lay, e, cap, x, slot, slot_tok, weights, gate, up, down):
    """One rank's part of the sharded layer (``_moe_sharded``), on local
    tensors: its token rows x (T_l, d_l), their plan rows ``slot`` and
    combine ``weights`` (T_l, k), the whole ``slot_tok`` (E, C), its
    experts' weights.  Returns its tokens' outputs (T_l, d_l).

    Every buffer of the exchange is indexed alike: row ((i M_g + j) E_l +
    e) C_l + c is slot (e0 + e, i C_l + c) of rank (i, j) of the group
    (j its model rank when M_g = M, e0 its first expert), and ``send``
    lists each of this rank's pairs' row there (R, past the end, for a
    dropped pair or, with M_g = 1, another model rank's expert)."""
    dr, mm, mg = lay.sizes()
    i_me, j_me = lay.coords()
    group = lay.group()
    t_l, k = slot.shape
    d_l = x.shape[1]
    d = d_l * mg
    e_l = e // mm if lay.cut else e
    c_l = -(-cap // dr)
    blk = e_l * c_l
    n_rows = dr * mg * blk
    dev = slot.device

    # ---- this rank's pairs' rows in the exchange
    sl = slot.long()
    kept = sl < e * cap
    ex, pos = sl // cap, sl % cap
    j_to = ex // e_l                     # the model rank of the pair's expert
    if mg == 1 and lay.cut:
        kept = kept & (j_to == j_me)     # the others' go through their column
    row = ((pos // c_l * mg + (j_to if mg > 1 else 0)) * e_l + ex
           - j_to * e_l) * c_l + pos % c_l
    send = torch.where(kept, row, n_rows)                       # (T_l, k)
    # the inverse: each row's (token, choice) of this rank, T_l k where it
    # holds none, by gathers and compares alone
    slot_tok = torch.cat([slot_tok, slot_tok.new_full(
        (e, dr * c_l - cap), t_l * dr)], 1).long()              # (E, D C_l)
    j_all = torch.arange(mg, device=dev)[:, None]
    e_of = (((j_all if mg > 1 else torch.full_like(j_all, j_me)) * e_l
             if lay.cut else j_all * 0)
            + torch.arange(e_l, device=dev))[None, :, :, None]
    pos_of = torch.arange(dr * c_l, device=dev).view(dr, 1, 1, c_l)
    tok = slot_tok[e_of, pos_of].reshape(-1) - i_me * t_l       # (R,)
    mine = (tok >= 0) & (tok < t_l)
    tok = torch.where(mine, tok, t_l)
    hit = torch.cat([sl, sl.new_full((1, k), -1)])[tok] == \
        (e_of * cap + pos_of).reshape(-1, 1)
    pair = torch.where(mine, tok * k + hit.int().argmax(1), t_l * k)

    # ---- dispatch: rows to the slots' ranks, summed over the senders
    out = DispatchGather.apply(x, tok, send)
    if group is not None:
        out = _AllToAll.apply(out, group)
    out = out.view(dr, mg, blk, d_l)
    buf = (out[0] if dr == 1 else out.sum(0)).permute(1, 0, 2).reshape(
        e_l, c_l, d)

    # ---- the experts on this rank's slots; under expert-TP every
    # expert's slots of this row block, this rank's FF slice
    tp = lay.cut and not lay.ep and mm > 1
    if tp:
        buf = _AllGather.apply(buf, lay.mesh.get_group(lay.split))
    h = F.silu(torch.bmm(buf, gate.to(buf.dtype)))
    h = h * torch.bmm(buf, up.to(buf.dtype))
    yexp = torch.bmm(h, down.to(buf.dtype))
    if tp:
        yexp = _ReduceScatter.apply(yexp, lay.mesh.get_group(lay.split))

    # ---- back to the tokens' ranks: row (i, j, r) is output row r's
    # columns j when its slot holds a token of row block i, else zero
    e0 = j_me * e_l if lay.cut else 0
    i_back = slot_tok[e0:e0 + e_l, i_me * c_l:(i_me + 1) * c_l].reshape(
        -1) // t_l                                              # D: empty
    cols = yexp.reshape(blk, mg, d_l).permute(1, 0, 2).reshape(mg * blk, d_l)
    r_idx = torch.arange(blk, device=dev)
    back = torch.where(i_back[None, None] == torch.arange(
        dr, device=dev)[:, None, None], j_all * blk + r_idx, mg * blk)
    where = torch.where(i_back < dr, (i_back * mg + j_all) * blk + r_idx,
                        n_rows)
    out = DispatchGather.apply(cols, back, where.reshape(mg * blk, 1))
    if group is not None:
        out = _AllToAll.apply(out, group)

    # ---- each pair's row, completed over the model axis where the
    # exchange did not cut d
    rows = DispatchGather.apply(out, send, pair[:, None]).view(t_l, k, d_l)
    if mg == 1 and lay.split is not None and mm > 1:
        rows = _AllReduce.apply(rows, lay.mesh.get_group(lay.split))
    return _weighted_sum(rows, weights)
