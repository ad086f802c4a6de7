"""K3's bf16 backward on the CPU: where the tensor-core kernels of
``csrc/mlstm_scan_bwd.cu`` round to bf16, emulated in plain PyTorch and held
to the plain float32 gradient ``ref.mlstm_chunkwise_bwd_ref`` within the
gates the card holds the kernels to (the error's norm below 1e-2 of the
plain gradient's, its max below 3e-2 of max(1, max |plain|)).

The kernels feed the tensor cores bf16 operands and sum in float32: the
states C and dC (bf16 copies beside the float32 C), G = dh / den where it
is an operand (S^T G; G C^T is dh C^T scaled by 1 / den afterwards), the
masked scores S and dS o D, and the two operands a per-step weight is
folded into (w o v in the forward walk, scale A o G in the reverse walk).
Both carries, 1 / den, da, <C, dC> and the gate gradients stay float32;
the cumulative gate sums float64.  Without rounding the emulation is the
plain gradient (and ``jax.vjp`` of the reference's differentiable scan),
so the gap the gates measure is the rounding alone.  Inputs come from
numpy with a fixed seed and are bf16 values, as the kernels get them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _mlstm_xla
from repro_torch.kernels import ref

L = 64   # steps a chunk, as the kernels take them


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(bh, s, dk, dv, qk, ssd, seed):
    rng = np.random.default_rng(seed)
    r = lambda *shape: torch.from_numpy(                      # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    q, k = _bf16(r(bh, s, dk) * qk), _bf16(r(bh, s, dk) * qk)
    v, dh = _bf16(r(bh, s, dv)), _bf16(r(bh, s, dv))
    g = r(bh, s)
    if ssd:      # hymba's SSD gates: decay -dt, input weight dt
        dt = torch.nn.functional.softplus(g * 1.5)
        return q, k, v, -dt, dt, dh
    return (q, k, v, torch.nn.functional.logsigmoid(g + 2.0),
            torch.sigmoid(r(bh, s)), dh)


def _scan_bwd_rounded(q, k, v, logf, i, dh, scale, rnd):
    """``ref.mlstm_chunkwise_bwd_ref``'s arithmetic in the kernels' order,
    with ``rnd`` applied to each bf16 operand of their products."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    nc = -(-s // L)
    pad = nc * L - s

    def tail(x):
        return torch.nn.functional.pad(
            x.float(), (0, 0, 0, pad) if x.dim() == 3 else (0, pad))
    qc, kc = (tail(x).reshape(bh, nc, L, dk) for x in (q, k))
    vc, gc = (tail(x).reshape(bh, nc, L, dv) for x in (v, dh))
    ic = tail(i).reshape(bh, nc, L)
    la64 = torch.cumsum(tail(logf).reshape(bh, nc, L).double(), dim=-1)
    total64 = la64[..., -1]
    total = total64.float()
    amul = la64.float().exp()
    w = ic * (total64[..., None] - la64).float().exp()
    tr = lambda x: x.transpose(-1, -2)                          # noqa: E731

    # the forward walk: C = exp(total) C + k^T (w o v), w o v rounded
    c_loc = tr(kc) @ rnd(vc * w[..., None])
    n_loc = (w[..., None, :] @ kc)[..., 0, :]
    c_st = torch.zeros((bh, nc, dk, dv))
    n_st = torch.zeros((bh, nc, dk))
    for j in range(1, nc):
        g = total[:, j - 1].exp()
        c_st[:, j] = g[:, None, None] * c_st[:, j - 1] + c_loc[:, j - 1]
        n_st[:, j] = g[:, None] * n_st[:, j - 1] + n_loc[:, j - 1]

    # the normaliser: P = scale q k^T, Y = dh v^T, num . dh with C as bf16
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    dec = torch.where(causal, la64[..., :, None] - la64[..., None, :],
                      -torch.inf).float().exp()
    dmat = dec * ic[..., None, :]
    pmat = (qc @ tr(kc)) * scale
    ymat = gc @ tr(vc)
    smat = pmat * dmat
    x = ((qc @ rnd(c_st)) * gc).sum(-1)
    numdot = amul * scale * x + (smat * ymat).sum(-1)
    a = amul * scale * (qc @ n_st[..., None])[..., 0] + smat.sum(-1)
    rden = 1.0 / a.abs().clamp(min=1.0)
    da = -numdot * rden ** 2 * a.sign() * (a.abs() > 1.0)

    # the reverse walk: dC = exp(total) dC + q^T (scale A rden o dh), the
    # weighted dh rounded
    dc_loc = tr(qc) @ rnd(gc * (scale * amul * rden)[..., None])
    dn_loc = (qc * (scale * amul * da)[..., None]).sum(-2)
    dc_st = torch.zeros_like(c_st)
    dn_st = torch.zeros_like(n_st)
    for j in range(nc - 2, -1, -1):
        g = total[:, j + 1].exp()
        dc_st[:, j] = g[:, None, None] * dc_st[:, j + 1] + dc_loc[:, j + 1]
        dn_st[:, j] = g[:, None] * dn_st[:, j + 1] + dn_loc[:, j + 1]

    # the gradient kernel: C, dC, S, dS o D and G (in S^T G) as bf16
    # operands
    g_op = rnd(gc * rden[..., None])
    ds = rden[..., None] * ymat + da[..., None]
    dsd = ds * dmat
    u = (rden[..., None] * (gc @ tr(rnd(c_st)))
         + da[..., None] * n_st[..., None, :])
    wv = vc @ tr(rnd(dc_st)) + dn_st[..., None, :]
    dq = scale * (rnd(dsd) @ kc + amul[..., None] * u)
    dkk = scale * (tr(rnd(dsd)) @ qc) + w[..., None] * wv
    dvv = tr(rnd(smat)) @ g_op + w[..., None] * (kc @ rnd(dc_st))

    # the gates, float32
    e_mat = ds * smat
    d_a = (scale * qc * u).sum(-1)
    d_w = (kc * wv).sum(-1)
    dla = e_mat.sum(-1) - e_mat.sum(-2) + amul * d_a - w * d_w
    di = ((ds * pmat * dec).sum(-2)
          + d_w * (total64[..., None] - la64).float().exp())
    dtotal = (total.exp() * ((c_st * dc_st).sum((-1, -2))
                             + (n_st * dn_st).sum(-1))
              + (d_w * w).sum(-1))
    dlogf = dla.flip(-1).cumsum(-1).flip(-1) + dtotal[..., None]

    def cut(x):
        return x.reshape(bh, nc * L, *x.shape[3:])[:, :s]
    return cut(dq), cut(dkk), cut(dvv), cut(dlogf), cut(di)


def _rows_above_1(q, k, logf, i, scale) -> float:
    """The share of rows with |q~_t . n_t| > 1, by the recurrence of n."""
    n = torch.zeros_like(k[:, 0])
    above = 0
    for t in range(q.shape[1]):
        n = logf[:, t, None].exp() * n + i[:, t, None] * k[:, t]
        above += int(((scale * q[:, t] * n).sum(-1).abs() > 1).sum())
    return above / (q.shape[0] * q.shape[1])


# bh, s, dk, dv, scale, qk, ssd
SHAPES = [
    (2, 256, 128, 128, None, 2.0, False),   # a reduced xlstm head
    (6, 256, 16, 64, 1.0, 1.0, True),       # hymba's SSD heads, steep decays
    (2, 150, 128, 128, None, 2.0, False),   # ragged S
    (3, 37, 16, 64, 1.0, 1.0, True),        # S below one chunk
    (3, 130, 32, 96, None, 1.5, False),     # dk, dv not multiples of 64
]
NAMES = ("dq", "dk", "dv", "dlogf", "di")


@pytest.mark.parametrize("bh,s,dk,dv,scale,qk,ssd", SHAPES)
def test_emulation_without_rounding_is_the_plain_gradient(bh, s, dk, dv, scale,
                                                          qk, ssd):
    x = _inputs(bh, s, dk, dv, qk, ssd, seed=bh + s)
    sc = dk ** -0.5 if scale is None else scale
    got = _scan_bwd_rounded(*x, sc, lambda t: t)
    want = ref.mlstm_chunkwise_bwd_ref(*x, scale=scale)
    for name, g, w in zip(NAMES, got, want):
        err = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        assert err < 2e-5, (name, err)


@pytest.mark.parametrize("bh,s,dk,dv,scale,qk,ssd", SHAPES)
def test_bf16_operands_keep_the_scan_backward_within_the_bf16_gates(
        bh, s, dk, dv, scale, qk, ssd):
    """With rows on both sides of |a| = 1 (both branches of the
    normaliser), the rounded gradient (dq, dk, dv stored in bf16, as the
    kernels store them) stays within the bf16 gates of the plain one."""
    x = _inputs(bh, s, dk, dv, qk, ssd, seed=bh + s)
    sc = dk ** -0.5 if scale is None else scale
    share = _rows_above_1(x[0], x[1], x[3], x[4], sc)
    assert 0 < share < 1, share
    want = ref.mlstm_chunkwise_bwd_ref(*x, scale=scale)
    got = _scan_bwd_rounded(*x, sc, _bf16)
    for j, (name, g, w) in enumerate(zip(NAMES, got, want)):
        g = _bf16(g) if j < 3 else g
        norm = ((g - w).norm() / w.norm()).item()
        rel = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        assert norm < 1e-2 and rel < 3e-2, (name, norm, rel)
        if j < 3:
            assert norm > 0, name      # the rounding is really emulated


def test_emulation_without_rounding_matches_the_reference_vjp():
    """The unrounded emulation against ``jax.vjp`` of the reference
    package's differentiable chunkwise scan (``_mlstm_xla``, its training
    path) at chunk 64, float32, 2e-5 of max(1, max |ref|)."""
    q, k, v, logf, i, dh = _inputs(2, 128, 32, 32, 1.5, False, seed=9)
    scale = 32 ** -0.5
    got = _scan_bwd_rounded(q, k, v, logf, i, dh, scale, lambda t: t)

    def f(q, k, v, logf, i):
        return _mlstm_xla(q, k, v, logf, i, scale=scale, chunk=L)
    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v, logf, i)))
    want = vjp(jnp.asarray(dh.numpy()))
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.asarray(w))
        err = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        assert err < 2e-5, (name, err)
