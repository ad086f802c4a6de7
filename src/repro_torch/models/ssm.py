"""SSM mixers: xLSTM's mLSTM block (matrix memory) and sLSTM block (scalar
memory), and the mamba-2/SSD-style heads of hymba's parallel SSM path.

The mLSTM and SSD sequence mixes run the chunkwise mLSTM scan kernel
(``ops.mlstm_scan``, K3; SSD with q = C, k = B, input weight dt, decay
-exp(a_log) dt and scale 1.0), whose gradient on the card is K3's
backward kernel (``ops.MlstmScan``); their decode steps are one step of
the recurrence in plain PyTorch, as in the reference.  The sLSTM block is a
per-channel linear recurrence, which the reference evaluates with an
associative scan that has no Pallas kernel; here it is a log-depth
doubling scan over time with the same combine.  A closed form through the
cumulative product of the forget gates is not used: over about a thousand
steps that product underflows in float32.

Decode state conventions (per layer):
* mLSTM : {"c": (B, H, hd, hd) f32, "n": (B, H, hd) f32}
* SSD   : {"c": (B, H, n, hd) f32, "n": (B, H, n) f32}, n = ``ssm.state_dim``
* sLSTM : {"c": (B, d) f32, "n": (B, d) f32}

Decode steps write their new state into ``out`` (a dict of tensors of the
state's shapes) when one is given, and never into the state they read.
The SSD heads' ``a_log`` is float32 whatever ``cfg.dtype`` is, as in the
reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers as L


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_init(gen, cfg, lead: tuple = ()):
    d = cfg.d_model
    h = cfg.n_heads
    di = cfg.ssm.expand * d
    hd = di // h
    dt = cfg.dtype
    return {
        "wq": L.linear_init(gen, d, di, dt, lead=lead),
        "wk": L.linear_init(gen, d, di, dt, lead=lead),
        "wv": L.linear_init(gen, d, di, dt, lead=lead),
        "wi": L.linear_init(gen, d, h, dt, bias=True, lead=lead),
        "wf": L.linear_init(gen, d, h, dt, bias=True, lead=lead),
        "wo": L.linear_init(gen, di, d, dt, lead=lead),
        "gate": L.linear_init(gen, d, di, dt, lead=lead),
        "norm": L.rmsnorm_init(hd, dt, gen.device, lead=lead),
    }


def _mlstm_qkv(cfg, p, x):
    b, s, d = x.shape
    h = cfg.n_heads
    di = cfg.ssm.expand * d
    hd = di // h

    def heads(y):
        return y.reshape(b, s, h, hd).transpose(1, 2)           # (B,H,S,hd)

    q = heads(L.linear(p["wq"], x))
    k = heads(L.linear(p["wk"], x))
    v = heads(L.linear(p["wv"], x))
    logf = F.logsigmoid(L.linear(p["wf"], x).float() + 2.0).transpose(1, 2)
    ig = torch.sigmoid(L.linear(p["wi"], x).float()).transpose(1, 2)  # (B,H,S)
    return q, k, v, logf, ig, (b, s, h, hd, di)


def mlstm_forward(cfg, p, x, *, return_state=False):
    q, k, v, logf, ig, (b, s, h, hd, di) = _mlstm_qkv(cfg, p, x)
    hseq = ops.mlstm_scan(q.reshape(b * h, s, hd), k.reshape(b * h, s, hd),
                          v.reshape(b * h, s, hd), logf.reshape(b * h, s),
                          ig.reshape(b * h, s))
    hseq = hseq.reshape(b, h, s, hd)
    hseq = L.rmsnorm(p["norm"], hseq).transpose(1, 2).reshape(b, s, di)
    y = L.linear(p["wo"], hseq * F.silu(L.linear(p["gate"], x)))
    if return_state:
        return y, _mlstm_final_state(q, k, v, logf, ig)
    return y


def _mlstm_final_state(q, k, v, logf, ig):
    """The final (C, n) carry for decode continuation (no initial state):
    C = sum_s w_s k_s v_s^T and n = sum_s w_s k_s, w = i * exp(total - la)."""
    la = torch.cumsum(logf, dim=-1)                       # (B,H,S)
    w = ig * torch.exp(la[..., -1:] - la)
    kw = k.float() * w[..., None]
    c = kw.transpose(-1, -2) @ v.float()                  # (B,H,hd,hd)
    n = kw.sum(dim=-2)
    return {"c": c, "n": n}


def mlstm_decode(cfg, p, x, state, out=None):
    """Single-step recurrence. x: (B,1,d)."""
    q, k, v, logf, ig, (b, s, h, hd, di) = _mlstm_qkv(cfg, p, x)
    qt = q[:, :, 0].float() * (hd ** -0.5)                # (B,H,hd)
    kt = k[:, :, 0].float()
    vt = v[:, :, 0].float()
    f = torch.exp(logf[..., 0])                           # (B,H)
    it = ig[..., 0]
    new = out if out is not None else {n: torch.empty_like(t)
                                       for n, t in state.items()}
    c = torch.mul(state["c"], f[..., None, None], out=new["c"])
    c.view(b * h, hd, hd).baddbmm_((it[..., None] * kt).reshape(b * h, hd, 1),
                                   vt.reshape(b * h, 1, hd))
    n = torch.add(f[..., None] * state["n"], it[..., None] * kt, out=new["n"])
    num = (qt[..., None, :] @ c)[..., 0, :]               # (B,H,hd)
    den = (qt * n).sum(-1).abs().clamp(min=1.0)
    hvec = (num / den[..., None]).to(x.dtype)
    hvec = L.rmsnorm(p["norm"], hvec).reshape(b, 1, di)
    y = L.linear(p["wo"], hvec * F.silu(L.linear(p["gate"], x)))
    return y, new


# ---------------------------------------------------------------------------
# SSD / mamba-2 heads (hymba's parallel path)
# ---------------------------------------------------------------------------

def ssd_init(gen, cfg, lead: tuple = ()):
    d = cfg.d_model
    h = cfg.n_heads
    n = cfg.ssm.state_dim
    hd = cfg.hd
    dt = cfg.dtype
    return {
        "wv": L.linear_init(gen, d, h * hd, dt, lead=lead),      # u (values)
        "wb": L.linear_init(gen, d, h * n, dt, lead=lead),       # B (k analogue)
        "wc": L.linear_init(gen, d, h * n, dt, lead=lead),       # C (q analogue)
        "wdt": L.linear_init(gen, d, h, dt, bias=True, lead=lead),
        "wo": L.linear_init(gen, h * hd, d, dt, lead=lead),
        "gate": L.linear_init(gen, d, h * hd, dt, lead=lead),
        "a_log": torch.zeros((*lead, h), dtype=torch.float32,   # decay rates
                             device=gen.device),
    }


def _ssd_proj(cfg, p, x):
    b, s, d = x.shape
    h = cfg.n_heads
    n = cfg.ssm.state_dim
    hd = cfg.hd

    def heads(y, w):
        return y.reshape(b, s, h, w).transpose(1, 2)             # (B,H,S,w)

    v = heads(L.linear(p["wv"], x), hd)
    kb = heads(L.linear(p["wb"], x), n)
    qc = heads(L.linear(p["wc"], x), n)
    dt = F.softplus(L.linear(p["wdt"], x).float()).transpose(1, 2)  # (B,H,S)
    a = -torch.exp(p["a_log"])[None, :, None]                    # (1,H,1) < 0
    logf = a * dt                                                # log decay
    return qc, kb, v, logf, dt, (b, s, h, n, hd)


def ssd_forward(cfg, p, x, *, return_state=False):
    qc, kb, v, logf, ig, (b, s, h, n, hd) = _ssd_proj(cfg, p, x)
    hseq = ops.mlstm_scan(qc.reshape(b * h, s, n), kb.reshape(b * h, s, n),
                          v.reshape(b * h, s, hd), logf.reshape(b * h, s),
                          ig.reshape(b * h, s), scale=1.0)
    hseq = hseq.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)
    y = L.linear(p["wo"], hseq * F.silu(L.linear(p["gate"], x)))
    if return_state:
        return y, _mlstm_final_state(qc, kb, v, logf, ig)
    return y


def ssd_decode(cfg, p, x, state, out=None):
    """Single-step recurrence, x: (B,1,d): no ``hd ** -0.5`` on q, and the
    denominator max(|q . n|, 1)."""
    qc, kb, v, logf, ig, (b, s, h, n, hd) = _ssd_proj(cfg, p, x)
    qt = qc[:, :, 0].float()                              # (B,H,n)
    kt = kb[:, :, 0].float()
    vt = v[:, :, 0].float()                               # (B,H,hd)
    f = torch.exp(logf[..., 0])                           # (B,H)
    it = ig[..., 0]
    new = out if out is not None else {k: torch.empty_like(t)
                                       for k, t in state.items()}
    c = torch.mul(state["c"], f[..., None, None], out=new["c"])
    c.view(b * h, n, hd).baddbmm_((it[..., None] * kt).reshape(b * h, n, 1),
                                  vt.reshape(b * h, 1, hd))
    nrm = torch.add(f[..., None] * state["n"], it[..., None] * kt, out=new["n"])
    num = (qt[..., None, :] @ c)[..., 0, :]               # (B,H,hd)
    den = (qt * nrm).sum(-1).abs().clamp(min=1.0)
    hvec = (num / den[..., None]).to(x.dtype).reshape(b, 1, h * hd)
    y = L.linear(p["wo"], hvec * F.silu(L.linear(p["gate"], x)))
    return y, new


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM scalar memory)
# ---------------------------------------------------------------------------

def slstm_init(gen, cfg, lead: tuple = ()):
    d = cfg.d_model
    dt = cfg.dtype
    return {
        "wz": L.linear_init(gen, d, d, dt, bias=True, lead=lead),
        "wi": L.linear_init(gen, d, d, dt, bias=True, lead=lead),
        "wf": L.linear_init(gen, d, d, dt, bias=True, lead=lead),
        "wout": L.linear_init(gen, d, d, dt, bias=True, lead=lead),
        "proj": L.linear_init(gen, d, d, dt, lead=lead),
    }


def _slstm_gates(p, x):
    z = torch.tanh(L.linear(p["wz"], x).float())
    i = torch.sigmoid(L.linear(p["wi"], x).float())
    f = torch.sigmoid(L.linear(p["wf"], x).float() + 2.0)
    o = torch.sigmoid(L.linear(p["wout"], x).float())
    return z, i, f, o


def _linear_scan(f, u, w):
    """Inclusive scan over axis 1 of the affine maps s -> f s + (u, w), the
    reference's ``combine(a, b) = (fa fb, fb ca + cb, fb na + nb)``, by
    doubling: after the step of offset ``o`` each position holds the
    composition of the last ``2 o`` maps.  Returns the (c, n) parts."""
    s = f.shape[1]
    off = 1
    while off < s:
        fp, up, wp = f[:, :-off], u[:, :-off], w[:, :-off]
        fb = f[:, off:]
        u = torch.cat([u[:, :off], fb * up + u[:, off:]], dim=1)
        w = torch.cat([w[:, :off], fb * wp + w[:, off:]], dim=1)
        f = torch.cat([f[:, :off], fp * fb], dim=1)
        off *= 2
    return u, w


def slstm_forward(cfg, p, x, *, return_state=False):
    """Per-channel linear recurrence c_t = f c + i z, n_t = f n + i,
    h = o * c/max(|n|, 1) -- a scan over time."""
    z, i, f, o = _slstm_gates(p, x)
    c_, n_ = _linear_scan(f, i * z, i)
    hseq = o * c_ / n_.abs().clamp(min=1.0)
    y = L.linear(p["proj"], hseq.to(x.dtype))
    if return_state:
        return y, {"c": c_[:, -1], "n": n_[:, -1]}
    return y


def slstm_decode(cfg, p, x, state, out=None):
    z, i, f, o = _slstm_gates(p, x)
    new = out if out is not None else {n: torch.empty_like(t)
                                       for n, t in state.items()}
    c = torch.add(f[:, 0] * state["c"], i[:, 0] * z[:, 0], out=new["c"])
    n = torch.add(f[:, 0] * state["n"], i[:, 0], out=new["n"])
    h = o[:, 0] * c / n.abs().clamp(min=1.0)
    y = L.linear(p["proj"], h[:, None].to(x.dtype))
    return y, new
