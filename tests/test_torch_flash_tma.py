"""K1's wrappers around the bf16 TMA kernels (the forward and, since its
redesign on a TMA producer, the backward), on the CPU: what they refuse
before any launch, what they copy first (and count), what they hand the
kernels, and how a tensor map the driver refuses comes back.  Fake tensors
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


def _bwd_args(mode, b=1, s=8, h=4, kh=2, hd=64, hdv=64, dtype=torch.bfloat16):
    """q, k, v, o, lse and do for ``flash_attention_bwd``, fake and packed."""
    return (_fake(mode, b, s, h, hd, dtype=dtype),
            _fake(mode, b, s, kh, hd, dtype=dtype),
            _fake(mode, b, s, kh, hdv, dtype=dtype),
            _fake(mode, b, s, h, hdv, dtype=dtype),
            _fake(mode, b, h, s, dtype=torch.float32),
            _fake(mode, b, s, h, hdv, dtype=dtype))


@pytest.mark.parametrize("which,copies", [
    ("packed", 0),
    ("do_transposed", 0),     # a strided view a map describes: read as is
    ("o_transposed", 0),      # o is read through its strides, no map
    ("k_expanded", 1),        # stride 0 over the KV heads
    ("kv_expanded", 2),
    ("q_offset", 1),          # rows one element off 16 bytes
    ("do_offset", 1),
    ("do_strided_head_dim", 1),
])
def test_bf16_backward_copies_what_no_tensor_map_describes(which, copies):
    """The backward reads q, k, v and do through tensor maps: what no map
    describes is copied into a fresh contiguous tensor first and counted in
    ``tma_copies``, as in the forward; do from autograd as a transposed
    view is described by a map and not copied; o is read through its
    strides.  The gradients come back contiguous in the inputs' shapes;
    fake tensors launch nothing."""
    mode = FakeTensorMode()
    q, k, v, o, lse, do = _bwd_args(mode)
    if which == "do_transposed":
        do = _fake(mode, 1, 4, 8, 64).transpose(1, 2)
    elif which == "o_transposed":
        o = _fake(mode, 1, 4, 8, 64).transpose(1, 2)
    elif which.endswith("expanded"):
        k = _fake(mode, 1, 8, 1, 64).expand(1, 8, 2, 64)
        if which == "kv_expanded":
            v = _fake(mode, 1, 8, 1, 64).expand(1, 8, 2, 64)
    elif which.endswith("_offset"):
        t = _fake(mode, 8 * 4 * 64 + 1)[1:].view(1, 8, 4, 64)
        q, do = (t, do) if which == "q_offset" else (q, t)
    elif which == "do_strided_head_dim":
        do = _fake(mode, 1, 8, 4, 128)[..., ::2]
    n, c = kflash.bwd_launches.count, kflash.tma_copies.count
    with mode:
        dq, dk, dv = kflash.flash_attention_bwd(q, k, v, o, lse, do)
    assert kflash.tma_copies.count == c + copies
    assert kflash.bwd_launches.count == n
    for g, shape in ((dq, (1, 8, 4, 64)), (dk, (1, 8, 2, 64)),
                     (dv, (1, 8, 2, 64))):
        assert tuple(g.shape) == shape and g.is_contiguous()
        assert g.dtype == torch.bfloat16


def test_float32_backward_packs_its_inputs_without_counting():
    """The float32 kernels read q, k, v and do packed by pointer: a strided
    do is copied, but that is no tensor map's copy and is not counted."""
    mode = FakeTensorMode()
    q, k, v, o, lse, _ = _bwd_args(mode, dtype=torch.float32)
    do = _fake(mode, 1, 4, 8, 64, dtype=torch.float32).transpose(1, 2)
    c = kflash.tma_copies.count
    with mode:
        dq, _, _ = kflash.flash_attention_bwd(q, k, v, o, lse, do)
    assert kflash.tma_copies.count == c
    assert dq.dtype == torch.float32 and dq.is_contiguous()


@pytest.mark.parametrize("bad", ["o_shape", "do_dtype", "lse_dtype",
                                 "lse_shape", "dims", "heads"])
def test_backward_refuses_before_any_copy_or_launch(bad):
    """Inputs the kernels do not take are refused before anything is
    copied or launched: o or do not (B, Sq, H, hdv) in q's dtype, lse not
    (B, H, Sq) float32, a pair of head dims neither equal and taken nor
    MLA's, query heads not a multiple of the KV heads."""
    mode = FakeTensorMode()
    q, k, v, o, lse, do = _bwd_args(mode)
    if bad == "o_shape":
        o = _fake(mode, 1, 8, 4, 32)
    elif bad == "do_dtype":
        do = _fake(mode, 1, 8, 4, 64, dtype=torch.float32)
    elif bad == "lse_dtype":
        lse = _fake(mode, 1, 4, 8)
    elif bad == "lse_shape":
        lse = _fake(mode, 1, 8, 4, dtype=torch.float32)
    elif bad == "dims":
        q, k, v, o, lse, do = _bwd_args(mode, hd=96, hdv=96)
    else:
        q, k, v, o, lse, do = _bwd_args(mode, h=3, kh=2)
    k = _fake(mode, 1, 8, 1, k.shape[-1]).expand(*k.shape)   # would copy
    n, c = kflash.bwd_launches.count, kflash.tma_copies.count
    with mode, pytest.raises(ValueError):
        kflash.flash_attention_bwd(q, k, v, o, lse, do)
    assert (kflash.bwd_launches.count, kflash.tma_copies.count) == (n, c)


def test_a_refused_backward_tensor_map_names_the_backward():
    """The backward's C entry point returns TMA_REFUSED + the CUresult for
    a map the driver refuses, as the forward's does; the wrapper raises it
    as a ValueError that names the backward and its mapped inputs, and
    lets every other code through to the launch check."""
    with pytest.raises(ValueError, match=r"flash_attention_bwd: .*q, k, v "
                                         r"or do \(CUresult 700\)"):
        kflash._raise_if_refused(kflash.TMA_REFUSED + 700,
                                 "flash_attention_bwd", "q, k, v or do")
    for err in (0, 1, 700, kflash.TMA_REFUSED - 1):
        kflash._raise_if_refused(err, "flash_attention_bwd", "q, k, v or do")


def test_backward_interface_passes_every_stride():
    """The C interface of the backward takes (batch, row, head) strides of
    q, k, v, o and do after the sizes: ten pointers, five sizes, fifteen
    strides, the scale, five ints and the stream."""
    import ctypes
    types = kflash._BWD_ARGTYPES
    assert types[:10] == [ctypes.c_void_p] * 10
    assert types[10:15] == [ctypes.c_int] * 5
    assert types[15:30] == [ctypes.c_longlong] * 15
    assert types[30:] == [ctypes.c_float] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
