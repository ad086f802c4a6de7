"""K1's gradient on the CPU: the plain backward ``ref.grouped_flash_bwd_ref``
(the formulas the backward kernel computes) against torch autograd of
``ref.grouped_flash_ref`` and against ``jax.vjp`` of the reference
package's differentiable blocked flash (``_flash_xla``, its training
path), and the forward's row logsumexp against ``torch.logsumexp`` of the
scores.  Float32, inputs from numpy with a fixed seed, 2e-5: the three
sum in different orders.  The CUDA kernels themselves are held to these
plain versions in ``test_torch_kernels_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _flash_xla
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref

TOL = 2e-5

# b, sq, sk, h, kh, hd, causal, window
SHAPES = [
    (2, 16, 16, 4, 2, 16, True, 0),     # causal, G = 2
    (2, 16, 16, 2, 2, 16, True, 0),     # causal, G = 1
    (1, 24, 24, 4, 2, 8, True, 5),      # window, G = 2
    (2, 12, 20, 2, 2, 8, False, 0),     # unmasked, Sq < Sk, G = 1
    (1, 8, 20, 4, 2, 16, True, 0),      # causal, Sq < Sk (queries last)
    (2, 10, 20, 4, 1, 8, True, 6),      # causal window, Sq < Sk, G = 4
    (1, 17, 17, 4, 2, 32, True, 0),     # ragged length
]


def _inputs(b, sq, sk, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", SHAPES)
def test_backward_formulas_match_torch_autograd(b, sq, sk, h, kh, hd, causal,
                                                window):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, sq, sk, h, kh, hd))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o, lse = ref.grouped_flash_ref(qg, kg, vg, causal=causal, window=window,
                                   return_lse=True)
    want = torch.autograd.grad(o, (qg, kg, vg), do)
    got = ref.grouped_flash_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                    causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _err(g, w) < TOL, (name, _err(g, w))


def _jax_grads(q, k, v, do, causal, window, scale):
    """jax.vjp of the reference's blocked flash, in its (BH, S, D) form:
    K/V repeated over each group's query heads (as the reference's GQA
    does), their gradient summed back over the group."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh

    def bh(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(-1, x.shape[1], x.shape[3])

    def f(q, k, v):
        kr, vr = (jnp.repeat(x, g, axis=2) for x in (k, v))
        out = _flash_xla(bh(q), bh(kr), bh(vr), causal=causal, window=window,
                         scale=scale)
        return jnp.transpose(out.reshape(b, h, sq, hd), (0, 2, 1, 3))
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", SHAPES)
def test_backward_formulas_match_reference_vjp(b, sq, sk, h, kh, hd, causal,
                                               window):
    q, k, v, do = _inputs(b, sq, sk, h, kh, hd, seed=1)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.grouped_flash_ref(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    got = ref.grouped_flash_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                    window=window)
    want = _jax_grads(q, k, v, do, causal, window, hd ** -0.5)
    for name, g, w in zip("qkv", got, want):
        assert _err(g, w) < TOL, (name, _err(g, w))


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", SHAPES)
def test_lse_is_logsumexp_of_kept_scores(b, sq, sk, h, kh, hd, causal, window):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(b, sq, sk, h, kh, hd))
    _, lse = ref.grouped_flash_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    kr = k.repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q, kr) * hd ** -0.5
    offs = sk - sq if causal else 0
    i = torch.arange(sq)[:, None] + offs
    j = torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    want = torch.logsumexp(s.masked_fill(~keep, -torch.inf), dim=-1)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert _err(lse, want) < 1e-5


def test_row_that_keeps_no_key_gets_zero_gradient():
    """Causal with Sq > Sk: the first rows see no key.  Their lse is -inf,
    and the backward gives them P = 0 -- no NaN, no gradient."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 12, 8, 2, 1, 8))
    o, lse = ref.grouped_flash_ref(q, k, v, causal=True, return_lse=True)
    assert torch.isinf(lse[:, :, :4]).all() and torch.isfinite(lse[:, :, 4:]).all()
    dq, dk, dv = ref.grouped_flash_bwd_ref(q, k, v, o, lse, do, causal=True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert (dq[:, :4] == 0).all()


def test_grouped_flash_on_cpu_is_differentiated_by_autograd():
    """On the CPU ``ops.grouped_flash`` is the plain version, and its
    autograd gradient is the one the backward kernel is held to."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 16, 16, 4, 2, 16))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.grouped_flash(qg, kg, vg, causal=True, window=6)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    o, lse = ref.grouped_flash_ref(q, k, v, causal=True, window=6,
                                   return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, o, lse, do, causal=True, window=6)
    for g, w in zip(got, want):
        assert _err(g, w) < TOL


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 8, 8, 2, 1, 16))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention_bwd(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention(q, k, v, return_lse=True)
