"""K1's wrapper around the bf16 TMA kernel, on the CPU: what it refuses
before any launch, what it copies first (and counts), what it hands the
kernel, and how a tensor map the driver refuses comes back.  Fake tensors
stand for CUDA ones (the wrapper's shape-only path), so nothing is built
or launched here; the kernel itself is held to its plain version on the
card (tests/test_torch_kernels_gpu.py).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import flash_attention as kflash


def _fake(mode, *shape, dtype=torch.bfloat16):
    return mode.from_tensor(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("which", ["k", "v", "kv", "q_offset", "k_offset",
                                   "q_strided_head_dim"])
def test_bf16_wrapper_refuses_a_zero_stride_before_any_launch(which):
    """What no tensor map describes -- an expanded K or V (stride 0 over its
    heads), a view whose rows start off 16 bytes (one element into its
    storage), a head dim that is not contiguous -- is no longer refused:
    the wrapper copies each such input into a fresh contiguous tensor
    before the tensor maps are encoded, and counts each copy in
    ``tma_copies`` (the reference's kernel takes any array).  Inputs a map
    describes are not copied; a launch counts as before."""
    mode = FakeTensorMode()
    t = {n: _fake(mode, 1, 8, 4, 64) for n in "qkv"}
    if which in ("k", "v", "kv"):
        for n in which:
            t[n] = _fake(mode, 1, 8, 1, 64).expand(1, 8, 4, 64)
    elif which.endswith("_offset"):
        t[which[0]] = _fake(mode, 8 * 4 * 64 + 1)[1:].view(1, 8, 4, 64)
    else:
        t["q"] = _fake(mode, 1, 8, 4, 128)[..., ::2]
    copies = len(which) if which in ("k", "v", "kv") else 1
    n, c = kflash.launches.count, kflash.tma_copies.count
    with mode:
        out = kflash.flash_attention(t["q"], t["k"], t["v"])
    assert tuple(out.shape) == (1, 8, 4, 64) and out.dtype == torch.bfloat16
    assert kflash.tma_copies.count == c + copies
    assert kflash.launches.count == n     # fake tensors: shapes alone


def test_bf16_wrapper_copies_nothing_a_tensor_map_describes():
    """Contiguous inputs and strided views of one fused projection reach
    the kernel as they are: no copy counted."""
    mode = FakeTensorMode()
    fused = _fake(mode, 2, 40, 12, 64)
    c = kflash.tma_copies.count
    with mode:
        kflash.flash_attention(*(_fake(mode, 1, 8, 4, 64) for _ in "qkv"))
        kflash.flash_attention(fused[:, :, :8], fused[:, :, 8:10],
                               fused[:, :, 10:])
    assert kflash.tma_copies.count == c


def test_float32_wrapper_refuses_a_strided_head_dim():
    """The float32 kernel reads a row's elements one after another: a head
    dim that is not contiguous is refused, not copied."""
    mode = FakeTensorMode()
    q = _fake(mode, 1, 8, 4, 128, dtype=torch.float32)[..., ::2]
    k = _fake(mode, 1, 8, 4, 64, dtype=torch.float32)
    c = kflash.tma_copies.count
    with mode, pytest.raises(ValueError, match="head dim"):
        kflash.flash_attention(q, k, k)
    assert kflash.tma_copies.count == c


def test_float32_wrapper_keeps_taking_a_zero_stride():
    """The float32 kernel reads rows by pointer, not through a tensor map:
    an expanded float32 K is still taken (the shape-only path here)."""
    mode = FakeTensorMode()
    q = _fake(mode, 1, 8, 4, 64, dtype=torch.float32)
    k = _fake(mode, 1, 8, 1, 64, dtype=torch.float32).expand(1, 8, 4, 64)
    with mode:
        out = kflash.flash_attention(q, k, k)
    assert tuple(out.shape) == (1, 8, 4, 64) and out.dtype == torch.float32


@pytest.mark.parametrize("hd,hdv", [(64, 64), (80, 80), (16, 16), (192, 128)])
def test_bf16_strided_views_of_one_projection_are_taken(hd, hdv):
    """q, k and v as views of one fused projection (no stride packed, V a
    column slice at 192 / 128 as MLA passes it) pass the wrapper's checks:
    every stride a multiple of 8 elements, none 0."""
    mode = FakeTensorMode()
    fused = _fake(mode, 2, 40, 8 + 2 * 2, hd)
    q, k = fused[:, :, :8], fused[:, :, 8:10]
    v = fused[:, :, 10:, :hdv]
    with mode:
        out, lse = kflash.flash_attention(q, k, v, return_lse=True)
    assert tuple(out.shape) == (2, 40, 8, hdv) and out.dtype == torch.bfloat16
    assert tuple(lse.shape) == (2, 8, 40) and lse.dtype == torch.float32


def test_a_refused_tensor_map_raises_with_its_cuda_result():
    """The C entry point returns TMA_REFUSED + the driver's CUresult when it
    cannot encode a map; the wrapper raises that as a ValueError and lets
    every other code through to the launch check."""
    with pytest.raises(ValueError, match=r"CUresult 1\)"):
        kflash._raise_if_refused(kflash.TMA_REFUSED + 1)
    for err in (0, 1, 700, kflash.TMA_REFUSED - 1):
        kflash._raise_if_refused(err)


def test_encode_timing_takes_only_bfloat16():
    """Only the bf16 kernel reads through tensor maps; float32 inputs are
    refused before anything is built."""
    mode = FakeTensorMode()
    q = _fake(mode, 1, 8, 4, 64, dtype=torch.float32)
    with mode, pytest.raises(TypeError, match="bfloat16"):
        kflash.tma_encode_us(q, q, q)
