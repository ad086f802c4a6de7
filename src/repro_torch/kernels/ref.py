"""Plain PyTorch versions of the port's kernels, float32 inside, cast back
to the input type.  The CPU path runs them; on the card they are what each
kernel is held against.

* ``grouped_flash_ref`` / ``grouped_decode_ref`` -- dense attention (K1,
  K2) in the model's layout, q (B, S, H, hd) and k, v (B, Sk, KH, hd) with
  query head ``h`` reading KV head ``h // G``; ``ops`` serves the reference
  package's (BH, S, D) signatures through them; ``grouped_decode_split_ref``
  is K2's split-and-merge arithmetic, for the tests;
* ``grouped_flash_bwd_ref`` -- the gradient of K1 (its backward kernel's
  plain version), from the forward's output and row logsumexp;
* ``moe_topk_ref`` -- the MoE router's top k (K4); ``moe_route_ref``, the
  router with the dispatch plan the reference builds by a stable sort, and
  ``moe_route_blocked_ref``, the kernel's count-based arithmetic for that
  plan, for the tests; ``moe_route_bwd_ref``, the gradient of the weights
  and probability sums (K4's backward kernel);
* ``mlstm_chunkwise_ref`` -- the chunkwise mLSTM scan (K3);
  ``mlstm_chunkwise_bwd_ref``, its gradient written out (K3's backward
  kernel's plain version);
  ``mlstm_chunk_parallel_ref``, the arithmetic of K3's chunk-parallel plan,
  and ``mlstm_scan_ref``, the step-by-step recurrence, for the tests.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def _flash_mask(sq: int, sk: int, causal: bool, window: int, device):
    """(Sq, Sk) keep mask: causal with the queries at the last Sq key
    positions, a sliding window, or neither."""
    qpos = (torch.arange(sq, device=device)[:, None]
            + (sk - sq if causal else 0))
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def grouped_flash_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      scale: float | None = None, return_lse: bool = False):
    """Dense softmax attention. q: (B, Sq, H, hd); k: (B, Sk, KH, hd);
    v: (B, Sk, KH, hdv), whose head dim may differ (MLA) -> (B, Sq, H,
    hdv).  With ``return_lse`` also the natural-log logsumexp of each
    row's kept scaled scores, (B, H, Sq) float32, -inf for a row that keeps
    no key."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kh, h // kh, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    mask = _flash_mask(sq, sk, causal, window, q.device)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    return out, lse.reshape(b, h, sq)


def grouped_flash_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                          window: int = 0, scale: float | None = None):
    """The gradient of ``grouped_flash_ref`` written out, float32 inside:
    ``D = rowsum(dO o O)``, ``P = exp(S - lse)`` on the kept pairs (0
    elsewhere, and on a row whose ``lse`` is -inf), ``dV = P^T dO`` summed
    over each KV head's G query heads, ``dS = P o (dO V^T - D)``, ``dQ =
    scale dS K``, ``dK = scale dS^T Q``.  q, o, do: (B, Sq, H, hd); k, v:
    (B, Sk, KH, hd); lse: (B, H, Sq).  Returns (dq, dk, dv) in the types of
    q, k and v."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, sq, kh, g, hd)
    kf, vf = k.float(), v.float()
    of = o.float().reshape(b, sq, kh, g, -1)
    dof = do.float().reshape(b, sq, kh, g, -1)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    lse = lse.float().reshape(b, kh, g, sq)
    live = torch.isfinite(lse)
    keep = _flash_mask(sq, sk, causal, window, q.device) & live[..., None]
    p = torch.where(keep, torch.exp(s - torch.where(live, lse, 0.0)[..., None]),
                    0.0)
    d = torch.einsum("bqkgd,bqkgd->bkgq", dof, of)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def grouped_decode_split_ref(q, k, v, lengths, *, n_split: int, chunk: int,
                             scale: float | None = None):
    """K2's split and merge in plain PyTorch (tests only): split ``i``
    attends over positions ``[i * chunk, (i + 1) * chunk)`` below the row's
    length and keeps a partial (max m, sum l, unnormalised acc); the
    partials merge in split order by log-sum-exp.  A split with no live
    position has m = -inf, l = 0 and weight 0, so a row of length 0 gets 0,
    as the Pallas kernel gives (the dense ``grouped_decode_ref`` gives the
    mean of V there).  Same arguments as ``grouped_decode_ref``."""
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(b, kh, h // kh, hd) * scale
    lengths = lengths.to(q.device).clamp(0, s)
    parts = []
    for i in range(n_split):
        lo, hi = i * chunk, min(s, (i + 1) * chunk)
        sc = torch.einsum("bkgd,bskd->bkgs", qg, k[:, lo:hi].float())
        live = (torch.arange(lo, hi, device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        sc = torch.where(live, sc, -torch.inf)
        m = sc.amax(-1)
        p = torch.where(live, torch.exp(sc - m.nan_to_num(neginf=0.0)[..., None]),
                        0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi].float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    l_tot = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for m, l_i, a_i in parts:
        w = torch.where(l_i > 0, torch.exp(m - big), 0.0)
        l_tot = l_tot + w * l_i
        acc = acc + w[..., None] * a_i
    out = torch.where(l_tot[..., None] > 0,
                      acc / l_tot.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE router (K4)
# ---------------------------------------------------------------------------

def moe_topk_ref(logits, top_k: int, n_valid: int | None = None):
    """Softmax over the experts below ``n_valid``, then top-k by ``top_k``
    masked-argmax passes, then renormalize.  logits: (T, E) ->
    (weights (T, k) float32, indices (T, k) int32).

    ``torch.argmax`` returns the first maximum, so ties go to the lowest
    index as in the reference (``torch.topk`` leaves the order of ties
    unspecified, and bfloat16 logits over 64 experts do tie)."""
    t, e = logits.shape
    probs = _router_probs(logits, e if n_valid is None else n_valid)
    weights = torch.empty((t, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    total = torch.zeros((t,), dtype=torch.float32, device=logits.device)
    for j in range(top_k):
        best = probs.argmax(dim=-1, keepdim=True)
        bestp = probs.gather(-1, best)
        weights[:, j:j + 1] = bestp
        idx[:, j:j + 1] = best
        total = total + bestp[:, 0]
        probs = probs.scatter(-1, best, NEG_INF)
    return weights / total.clamp(min=1e-9)[:, None], idx


class Route(NamedTuple):
    """The router's outputs and the dispatch plan of one MoE layer."""
    weights: torch.Tensor   # (T, k) float32, renormalised, times the scale
    idx: torch.Tensor       # (T, k) int32 experts
    slot: torch.Tensor      # (T, k) int32 row e * C + pos; E * C if dropped
    slot_tok: torch.Tensor  # (E, C) int32 token in each slot; T if empty
    prob_sum: torch.Tensor  # (E,) float32 softmax probabilities over tokens
    counts: torch.Tensor    # (E,) int32 pairs routed to each expert


def _router_probs(logits, n_valid):
    e = logits.shape[1]
    eidx = torch.arange(e, device=logits.device)
    return torch.softmax(torch.where(eidx < n_valid, logits.float(), NEG_INF),
                         dim=-1)


def moe_route_ref(logits, top_k: int, *, capacity: int,
                  n_valid: int | None = None, router_scale: float = 1.0):
    """The router and its dispatch plan as the reference computes them:
    ``moe_topk_ref`` times ``router_scale``; a stable argsort of the (token,
    choice) pairs by expert, each pair's position in its expert's run by
    ``searchsorted``, kept iff below ``capacity``; a bincount of the pairs
    and the softmax summed over tokens.  Returns a ``Route``."""
    t, e = logits.shape
    n_valid = e if n_valid is None else n_valid
    w, idx = moe_topk_ref(logits, top_k, n_valid=n_valid)
    dev = logits.device
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    eid_s = flat[order]
    pos_s = torch.arange(t * top_k, device=dev) - torch.searchsorted(eid_s, eid_s)
    dropped = e * capacity
    slot_s = torch.where(pos_s < capacity, eid_s * capacity + pos_s, dropped)
    slot = torch.empty_like(flat).scatter_(0, order, slot_s)
    # dropped pairs land in one extra cell, cut off after
    slot_tok = torch.full((dropped + 1,), t, dtype=torch.long, device=dev) \
        .scatter_(0, slot_s, order // top_k)[:dropped]
    return Route(w * router_scale, idx, slot.reshape(t, top_k).int(),
                 slot_tok.reshape(e, capacity).int(),
                 _router_probs(logits, n_valid).sum(dim=0),
                 torch.bincount(flat, minlength=e).int())


def moe_route_bwd_ref(logits, idx, weights, dweights, dprob_sum=None, *,
                      n_valid: int | None = None, router_scale: float = 1.0):
    """The gradient of ``moe_route_ref``'s weights and probability sums
    with respect to the logits (K4's backward kernel's plain version),
    written out.  With p the softmax over the experts below ``n_valid`` in
    float32, r = weights / router_scale (the renormalised picks, summing to
    1) and g = dprob_sum (zeros if None: ``moe_topk``'s gradient),
    ``dl_e = p_e (g_e - sum_e' p_e' g_e') + [e = idx_m] router_scale r_m
    (dw_m - sum_j r_j dw_j)``: the softmax's denominator cancels in the
    renormalised weights.  Padded experts get 0.  logits (T, E); idx,
    weights, dweights (T, k); dprob_sum (E,).  Returns (T, E) in logits'
    type."""
    e = logits.shape[1]
    p = _router_probs(logits, e if n_valid is None else n_valid)
    dl = torch.zeros_like(p)
    if dprob_sum is not None:
        g = dprob_sum.float()[None, :]
        dl = p * (g - (p * g).sum(dim=-1, keepdim=True))
    r = weights.float() / router_scale
    dw = dweights.float()
    coeff = router_scale * r * (dw - (r * dw).sum(dim=-1, keepdim=True))
    # a token picks an expert at most once, so the adds do not collide
    return dl.scatter_add(1, idx.long(), coeff).to(logits.dtype)


def moe_route_blocked_ref(logits, top_k: int, *, capacity: int,
                          tokens_per_block: int, n_valid: int | None = None,
                          router_scale: float = 1.0):
    """K4's plan arithmetic in plain PyTorch (tests only): the tokens cut
    into blocks of ``tokens_per_block``; in each block a pair's rank among
    the block's earlier tokens that picked its expert, and each expert's
    count; the position is the rank plus the counts of the blocks before
    (an exclusive prefix in block order).  Probabilities are summed by
    block, the blocks' sums then in block order.  No sort.  Same
    arguments as ``moe_route_ref`` and the same ``Route``."""
    t, e = logits.shape
    n_valid = e if n_valid is None else n_valid
    w, idx = moe_topk_ref(logits, top_k, n_valid=n_valid)
    dev = logits.device
    nb = max(1, -(-t // tokens_per_block))
    pad = nb * tokens_per_block - t
    picks = torch.zeros((t + pad, e), dtype=torch.long, device=dev)
    picks[:t].scatter_(1, idx.long(), 1)        # a token picks an expert once
    picks = picks.reshape(nb, tokens_per_block, e)
    rank = picks.cumsum(dim=1) - picks          # earlier tokens in the block
    per_block = picks.sum(dim=1)                # (nb, E)
    before = per_block.cumsum(dim=0) - per_block
    pos_te = (rank + before[:, None, :]).reshape(-1, e)[:t]
    pos = pos_te.gather(1, idx.long())          # (T, k)
    dropped = e * capacity
    slot = torch.where(pos < capacity, idx.long() * capacity + pos, dropped)
    tok = torch.arange(t, device=dev)[:, None].expand(t, top_k)
    slot_tok = torch.full((dropped + 1,), t, dtype=torch.long, device=dev) \
        .scatter_(0, slot.reshape(-1), tok.reshape(-1))[:dropped]
    probs = torch.nn.functional.pad(_router_probs(logits, n_valid), (0, 0, 0, pad))
    block_sums = probs.reshape(nb, tokens_per_block, e).sum(dim=1)
    prob_sum = block_sums[0]
    for b in range(1, nb):
        prob_sum = prob_sum + block_sums[b]
    return Route(w * router_scale, idx, slot.int(),
                 slot_tok.reshape(e, capacity).int(), prob_sum,
                 per_block.sum(dim=0).int())


# ---------------------------------------------------------------------------
# mLSTM scan (K3)
# ---------------------------------------------------------------------------

def mlstm_scan_ref(q, k, v, logf, i, *, scale: float | None = None):
    """Step-by-step mLSTM recurrence, the ground truth of the chunkwise
    forms (tests only).  q, k: (BH, S, dk); v: (BH, S, dv); logf, i:
    (BH, S).  Returns h (BH, S, dv) in q's dtype."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    f, ig = logf.float().exp(), i.float()
    c = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((bh, dk), dtype=torch.float32, device=q.device)
    hs = []
    for t in range(s):
        c = (f[:, t, None, None] * c
             + ig[:, t, None, None] * torch.einsum("bd,be->bde", kf[:, t], vf[:, t]))
        n = f[:, t, None] * n + ig[:, t, None] * kf[:, t]
        num = torch.einsum("bd,bde->be", qf[:, t], c)
        den = torch.einsum("bd,bd->b", qf[:, t], n).abs().clamp(min=1.0)
        hs.append(num / den[:, None])
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_chunkwise_ref(q, k, v, logf, i, *, scale: float | None = None,
                        chunk: int = 256):
    """Chunkwise-parallel mLSTM, the plain version of K3: within a chunk a
    decay-masked attention matrix, across chunks the carried state
    ``C`` (dk x dv) and ``n`` (dk), all float32.

    Takes any S: the tail is padded to a whole chunk with ``logf = 0`` and
    ``i = 0``, steps through which the state passes unchanged, so the
    padding is exact; the padded outputs are cut off.
    """
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    ch = min(chunk, s)
    nc = -(-s // ch)
    pad = nc * ch - s

    def tail(x):
        x = x.float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                       else (0, pad))

    qc = (tail(q) * scale).reshape(bh, nc, ch, dk)
    kc = tail(k).reshape(bh, nc, ch, dk)
    vc = tail(v).reshape(bh, nc, ch, dv)
    lc = tail(logf).reshape(bh, nc, ch)
    ic = tail(i).reshape(bh, nc, ch)
    causal = torch.ones((ch, ch), dtype=torch.bool, device=q.device).tril()
    c = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((bh, dk), dtype=torch.float32, device=q.device)
    hs = []
    for j in range(nc):
        qb, kb, vb, ib = qc[:, j], kc[:, j], vc[:, j], ic[:, j]
        # The decay between two steps is a difference of cumulative sums,
        # taken in float64: at SSD gates (hymba's decay up to e^-4.5 a
        # step) the float32 sums reach -300 within a chunk, where their
        # differences would be off by up to 2e-5.
        la64 = torch.cumsum(lc[:, j].double(), dim=-1)      # (BH, ch)
        la = la64.float()
        total = la[:, -1]
        qd = qb * la.exp()[..., None]
        inter = qd @ c                                      # (BH, ch, dv)
        n_inter = (qd @ n[..., None])[..., 0]               # (BH, ch)
        # masked before the exponential: above the diagonal the difference
        # is positive and may overflow, and inf there would turn the
        # gradient of the masked entries into NaN
        dmat = torch.where(causal, la64[:, :, None] - la64[:, None, :],
                           -torch.inf).float().exp() * ib[:, None, :]
        smat = (qb @ kb.transpose(1, 2)) * dmat             # (BH, ch, ch)
        intra = smat @ vb
        den = (n_inter + smat.sum(-1)).abs().clamp(min=1.0)
        hs.append((inter + intra) / den[..., None])
        w = ib * (la64[:, -1:] - la64).float().exp()        # (BH, ch)
        c = total.exp()[:, None, None] * c + (kb * w[..., None]).transpose(1, 2) @ vb
        n = total.exp()[:, None] * n + (w[:, None, :] @ kb)[:, 0]
    return torch.cat(hs, dim=1)[:, :s].to(q.dtype)


def mlstm_chunk_parallel_ref(q, k, v, logf, i, *, scale: float | None = None,
                             chunk: int = 64):
    """K3's chunk-parallel plan in plain PyTorch, float32 (tests only): (a)
    every chunk's own state ``dC = (k o w)^T v``, ``dn = w^T k`` with ``w =
    i exp(total - la)``, all chunks at once; (b) one pass in chunk order,
    ``C_{c+1} = exp(total_c) C_c + dC_c``, giving the state each chunk
    starts from; (c) every chunk's output from its starting state, all at
    once, as ``mlstm_chunkwise_ref`` computes it.  Any S, padded as there.
    Same arguments; returns h (BH, S, dv) in q's dtype."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    nc = max(1, -(-s // chunk))
    pad = nc * chunk - s

    def tail(x):
        x = x.float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                       else (0, pad))

    qc = (tail(q) * scale).reshape(bh, nc, chunk, dk)
    kc = tail(k).reshape(bh, nc, chunk, dk)
    vc = tail(v).reshape(bh, nc, chunk, dv)
    ic = tail(i).reshape(bh, nc, chunk)
    la = torch.cumsum(tail(logf).reshape(bh, nc, chunk), dim=-1)
    total = la[..., -1]                                       # (BH, nc)
    # (a) local states
    w = ic * (total[..., None] - la).exp()
    d_c = (kc * w[..., None]).transpose(-1, -2) @ vc          # (BH, nc, dk, dv)
    d_n = (w[..., None, :] @ kc)[..., 0, :]                   # (BH, nc, dk)
    # (b) carried states: the state before chunk c
    c_prev = torch.zeros((bh, nc, dk, dv), dtype=torch.float32, device=q.device)
    n_prev = torch.zeros((bh, nc, dk), dtype=torch.float32, device=q.device)
    for j in range(1, nc):
        g = total[:, j - 1].exp()
        c_prev[:, j] = g[:, None, None] * c_prev[:, j - 1] + d_c[:, j - 1]
        n_prev[:, j] = g[:, None] * n_prev[:, j - 1] + d_n[:, j - 1]
    # (c) outputs
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    qd = qc * la.exp()[..., None]
    inter = qd @ c_prev                                       # (BH, nc, L, dv)
    n_inter = (qd @ n_prev[..., None])[..., 0]                # (BH, nc, L)
    dmat = torch.where(causal, (la[..., :, None] - la[..., None, :]).exp()
                       * ic[..., None, :], 0.0)
    smat = (qc @ kc.transpose(-1, -2)) * dmat
    den = (n_inter + smat.sum(-1)).abs().clamp(min=1.0)
    h = (inter + smat @ vc) / den[..., None]
    return h.reshape(bh, nc * chunk, dv)[:, :s].to(q.dtype)


def mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, *, scale: float | None = None,
                            chunk: int = 64):
    """The gradient of ``mlstm_chunkwise_ref`` written out, float32 inside
    (the cumulative gate sums float64): K3's backward kernel's plain
    version, chunk for chunk.  In a chunk of ``chunk`` steps, with q~ =
    scale q, la the cumulative log forget gate, A = exp(la), D_tj = [j <=
    t] exp(la_t - la_j) i_j, P = q~ k^T, S = P o D, w_j = i_j exp(total -
    la_j), C, n the state before the chunk:

    * forward, recomputed: num = (A q~) C + S v, a = (A q~) n + rowsum S,
      den = max(|a|, 1); G = dh / den, and the normaliser's row scalar
      da = -(dh . num) / den^2 sign(a) [|a| > 1];
    * the state's gradient runs backward over the chunks: dC_before =
      exp(total) dC_after + (A q~)^T G, dn_before = exp(total) dn_after +
      (A q~)^T da;
    * dS = G v^T + da; dq~ = (dS o D) k + A (G C^T + da n); dk = (dS o
      D)^T q~ + w (v dC^T + dn); dv = S^T G + w (k dC);
    * gates: with E = dS o S, dla = rowsum E - colsum E + A dA - w dw, di
      = colsum(dS o P o exp(la_t - la_j)) + dw exp(total - la), where dA =
      q~ . (G C^T + da n) and dw = k . (v dC^T + dn); d total = exp(total)
      (<C, dC> + n . dn) + sum_j dw_j w_j; dlogf is the reverse cumulative
      sum of dla in the chunk plus d total.

    q, k: (BH, S, dk); v, dh: (BH, S, dv); logf, i: (BH, S).  Any S: the
    tail is padded to a whole chunk with logf = 0, i = 0 and zeros, as the
    forward pads it.  Returns (dq, dk, dv) in the types of q, k, v and
    (dlogf, di) float32."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    nc = max(1, -(-s // chunk))
    pad = nc * chunk - s

    def tail(x):
        x = x.float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                       else (0, pad))

    qc = (tail(q) * scale).reshape(bh, nc, chunk, dk)
    kc = tail(k).reshape(bh, nc, chunk, dk)
    vc = tail(v).reshape(bh, nc, chunk, dv)
    gc = tail(dh).reshape(bh, nc, chunk, dv)
    ic = tail(i).reshape(bh, nc, chunk)
    la64 = torch.cumsum(tail(logf).reshape(bh, nc, chunk).double(), dim=-1)
    total64 = la64[..., -1]
    total = total64.float()
    amul = la64.float().exp()                                   # A
    w = ic * (total64[..., None] - la64).float().exp()
    tr = lambda x: x.transpose(-1, -2)                          # noqa: E731

    # the state before each chunk
    c_loc = tr(kc * w[..., None]) @ vc                          # (BH, nc, dk, dv)
    n_loc = (w[..., None, :] @ kc)[..., 0, :]
    c_st = torch.zeros((bh, nc, dk, dv), dtype=torch.float32, device=q.device)
    n_st = torch.zeros((bh, nc, dk), dtype=torch.float32, device=q.device)
    for j in range(1, nc):
        g = total[:, j - 1].exp()
        c_st[:, j] = g[:, None, None] * c_st[:, j - 1] + c_loc[:, j - 1]
        n_st[:, j] = g[:, None] * n_st[:, j - 1] + n_loc[:, j - 1]

    # the chunk's forward, recomputed, and the normaliser's row scalars
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    dec = torch.where(causal, la64[..., :, None] - la64[..., None, :],
                      -torch.inf).float().exp()
    dmat = dec * ic[..., None, :]
    pmat = qc @ tr(kc)
    smat = pmat * dmat
    qa = qc * amul[..., None]
    num = qa @ c_st + smat @ vc
    a = (qa @ n_st[..., None])[..., 0] + smat.sum(-1)
    den = a.abs().clamp(min=1.0)
    g_mat = gc / den[..., None]
    da = -(gc * num).sum(-1) / den ** 2 * a.sign() * (a.abs() > 1.0)

    # the state's gradient, after each chunk
    dc_loc = tr(qa) @ g_mat
    dn_loc = (qa * da[..., None]).sum(-2)
    dc_st = torch.zeros_like(c_st)
    dn_st = torch.zeros_like(n_st)
    for j in range(nc - 2, -1, -1):
        g = total[:, j + 1].exp()
        dc_st[:, j] = g[:, None, None] * dc_st[:, j + 1] + dc_loc[:, j + 1]
        dn_st[:, j] = g[:, None] * dn_st[:, j + 1] + dn_loc[:, j + 1]

    ds = g_mat @ tr(vc) + da[..., None]
    dsd = ds * dmat
    u = g_mat @ tr(c_st) + da[..., None] * n_st[..., None, :]   # (.., L, dk)
    wv = vc @ tr(dc_st) + dn_st[..., None, :]
    dq = (dsd @ kc + amul[..., None] * u) * scale
    dkk = tr(dsd) @ qc + w[..., None] * wv
    dvv = tr(smat) @ g_mat + w[..., None] * (kc @ dc_st)
    e_mat = ds * smat
    d_a = (qc * u).sum(-1)
    d_w = (kc * wv).sum(-1)
    dla = e_mat.sum(-1) - e_mat.sum(-2) + amul * d_a - w * d_w
    di = ((ds * pmat * dec).sum(-2)
          + d_w * (total64[..., None] - la64).float().exp())
    dtotal = (total.exp() * ((c_st * dc_st).sum((-1, -2))
                             + (n_st * dn_st).sum(-1))
              + (d_w * w).sum(-1))
    dlogf = dla.flip(-1).cumsum(-1).flip(-1) + dtotal[..., None]

    def cut(x, like=None):
        x = x.reshape(bh, nc * chunk, *x.shape[3:])[:, :s]
        return x if like is None else x.to(like.dtype)
    return (cut(dq, q), cut(dkk, k), cut(dvv, v), cut(dlogf), cut(di))
