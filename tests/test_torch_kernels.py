"""The port's kernel plain versions against the reference package's: the
dense oracles in ``repro.kernels.ref``, the Pallas kernels run in interpret
mode, and the reference's grouped attention helpers.  Same numpy inputs
into both packages; float32 to 2e-5, bfloat16 to 3e-2 (the tolerances of
tests/test_kernels.py).  The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(a, dtype="float32"):
    """The same values as a torch CPU tensor and a JAX array."""
    return (torch.from_numpy(a).to(TDT[dtype]),
            jnp.asarray(a).astype(JDT[dtype]))


def maxdiff(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j.astype(jnp.float32)))))


# ------------------------------------------------------------ flash attn
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 256, 256, 64), (2, 128, 256, 32),
                                        (1, 512, 512, 128), (3, 128, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_reference_oracle(bh, sq, sk, d, dtype):
    (tq, jq), (tk, jk), (tv, jv) = (both(rand((bh, n, d), i), dtype)
                                    for i, n in ((1, sq), (2, sk), (3, sk)))
    r = jref.flash_attention_ref(jq, jk, jv, causal=True)
    o = tops.flash_attention(tq, tk, tv, causal=True)
    assert o.dtype == TDT[dtype] and o.shape == (bh, sq, d)
    assert maxdiff(o, r) < TOL[dtype]


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", [
    (4, 256, 256, 64, True, 0),
    (2, 128, 256, 32, True, 0),
    (3, 128, 128, 16, True, 0),
    (1, 512, 512, 128, True, 0),
    (2, 256, 256, 32, True, 64),
    (2, 128, 128, 64, False, 0),
])
def test_flash_ref_matches_pallas_interpret(bh, sq, sk, d, causal, window):
    (tq, jq), (tk, jk), (tv, jv) = (both(rand((bh, n, d), i))
                                    for i, n in ((4, sq), (5, sk), (6, sk)))
    r = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                             backend="interpret", block_q=128, block_k=128)
    o = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert maxdiff(o, r) < 2e-5


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 64, 8, 2, 16, True, 0),       # G = 4
    (1, 96, 14, 2, 32, True, 0),      # G = 7 (qwen2-0.5b heads)
    (2, 128, 8, 2, 32, True, 32),     # sliding window
    (2, 64, 8, 2, 16, False, 0),      # non-causal
    (1, 100, 14, 2, 16, True, 0),     # ragged length, G = 7
])
def test_grouped_flash_ref_matches_reference(b, s, h, kh, d, causal, window):
    """The port's grouped layout (no K/V repeat) against the reference's
    repeat-and-flatten ``_grouped_flash`` on its blocked xla path."""
    (tq, jq) = both(rand((b, s, h, d), 7))
    (tk, jk), (tv, jv) = (both(rand((b, s, kh, d), i)) for i in (8, 9))
    r = jattn._grouped_flash(jq, jk, jv, causal=causal, window=window,
                             backend="xla")
    o = tops.grouped_flash(tq, tk, tv, causal=causal, window=window)
    assert o.shape == (b, s, h, d)
    assert maxdiff(o, r) < 2e-5


def test_flash_ref_ragged_and_short_queries():
    """Sq < Sk places the queries at the last positions; lengths that are
    not block multiples need no padding."""
    (tq, jq) = both(rand((3, 37, 16), 10))
    (tk, jk), (tv, jv) = (both(rand((3, 101, 16), i)) for i in (11, 12))
    for causal, window in ((True, 0), (True, 20), (False, 0)):
        r = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
        o = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
        assert maxdiff(o, r) < 2e-5


# ---------------------------------------------------------- decode attn
@pytest.mark.parametrize("bh,s,d", [(6, 512, 64), (2, 2048, 128), (8, 256, 32)])
def test_decode_ref_matches_pallas_interpret(bh, s, d):
    (tq, jq) = both(rand((bh, 1, d), 1))
    (tk, jk), (tv, jv) = (both(rand((bh, s, d), i)) for i in (2, 3))
    lengths = (np.arange(bh) * (s // bh) + 1).astype(np.int32)
    r_ref = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    r_pl = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                 backend="interpret", block_k=128)
    o = tops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert maxdiff(o, r_ref) < 2e-5
    assert maxdiff(o, r_pl) < 2e-5


@pytest.mark.parametrize("b,s,h,kh,d,length", [
    (2, 64, 8, 2, 16, 40),       # G = 4
    (3, 48, 14, 2, 32, 48),      # G = 7, full cache
    (2, 32, 4, 4, 64, 1),        # G = 1, one live position
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_decode_ref_matches_reference(b, s, h, kh, d, length, dtype):
    """The decode kernel's plain version against the reference's einsum
    ``_grouped_decode`` -- the function the reference's decode step runs."""
    (tq, jq) = both(rand((b, 1, h, d), 4), dtype)
    (tk, jk), (tv, jv) = (both(rand((b, s, kh, d), i), dtype) for i in (5, 6))
    r = jattn._grouped_decode(jq, jk, jv, length)
    o = tops.grouped_decode(tq, tk, tv,
                            torch.full((b,), length, dtype=torch.int32))
    assert o.dtype == TDT[dtype]
    assert maxdiff(o, r) < TOL[dtype]


def test_grouped_decode_ref_ragged_lengths():
    """Per-row lengths: each (row, KV head) group against the reference
    oracle on the head-expanded (BH, 1, D) form."""
    b, s, h, kh, d = 3, 80, 14, 2, 16
    q, k, v = rand((b, 1, h, d), 7), rand((b, s, kh, d), 8), rand((b, s, kh, d), 9)
    lengths = np.array([1, 33, 80], np.int32)
    o = tops.grouped_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lengths))
    g = h // kh
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, 1, d)
    kf = np.repeat(k.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    vf = np.repeat(v.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    r = jref.decode_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                                  jnp.asarray(vf),
                                  jnp.asarray(np.repeat(lengths, h)))
    r = np.asarray(r).reshape(b, h, 1, d).transpose(0, 2, 1, 3)
    assert np.max(np.abs(o.numpy() - r)) < 2e-5


# -------------------------------------------------------------- dispatch
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: a CPU tensor is refused, never
    quietly run through the plain version."""
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, :1], q[:, :, :2], q[:, :, :2],
                                 torch.ones((1,), dtype=torch.int32))


def test_ops_dispatch_by_device():
    """CPU tensors take the plain version; a device with no path raises."""
    q = torch.from_numpy(rand((1, 8, 4, 16), 1))
    k = torch.from_numpy(rand((1, 8, 2, 16), 2))
    out = tops.grouped_flash(q, k, k, causal=True)
    assert torch.equal(out, tref.grouped_flash_ref(q, k, k, causal=True))
    with pytest.raises(ValueError, match="no path"):
        tops.grouped_flash(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        tops.grouped_decode(q[:, :1].to("meta"), k.to("meta"), k.to("meta"),
                            torch.ones((1,), dtype=torch.int32))
